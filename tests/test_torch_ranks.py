"""The multi-rank harness itself (`torch_ranks.run_world`): a rank that
raises fails its world in well under a minute, with the rank's own
message, while the other ranks still wait for it: in a collective that
notices the peer's exit, or on a store key that nothing will set (they
are killed `GRACE_S` seconds after the failure). A world that outruns its
timeout fails with every rank's stacks."""

import re
import time

import pytest

from torch_ranks import raising_world, run_world, stuck_world


@pytest.mark.parametrize('wait', ['all_reduce', 'store'])
def test_a_raising_rank_fails_the_world_fast(tmp_path, wait):
    with pytest.raises(RuntimeError, match='rank 1 gives up') as err:
        run_world(raising_world, 2, tmp_path, wait, timeout=400)
    raised = float(re.search(r'gives up at ([0-9.]+)', str(err.value))[1])
    assert time.time() - raised < 60          # not the world's 400 s
    assert str(err.value).startswith('raising_world: rank 1 failed')
    if wait == 'store':
        assert '1 of 2 ranks still running 30.0 s' in str(err.value)


def test_a_world_past_its_timeout_fails_with_its_stacks(tmp_path):
    with pytest.raises(TimeoutError, match='2 of 2 ranks still running') \
            as err:
        run_world(stuck_world, 2, tmp_path, timeout=45)
    for rank in (0, 1):
        assert f'rank {rank}:\n' in str(err.value)
    assert str(err.value).count('in stuck_world') == 2
