"""The operation counts the mfu and roofline metrics divide by."""

import pytest

from portbench import cells, flops


def test_joint_frame_is_benchmarks_mfu_hand_count():
    # benchmarks/mfu.py: Darknet-19 conv by conv at 416² with 12 classes
    # and 5 anchors (29.35 GFLOP) plus the ConvLSTM-512 head (10.11)
    cfg = cells.cell('joint_serve_b8').config
    assert flops.forward_per_frame(cfg) / 1e9 == pytest.approx(39.46006,
                                                               abs=1e-5)


def test_yolov2_frame():
    cfg = cells.cell('yolov2_train_b32').config
    assert flops.forward_per_frame(cfg) / 1e9 == pytest.approx(29.46417,
                                                               abs=1e-5)


def test_train_step_counts_each_gradient_once():
    cfg = cells.cell('yolov2_train_b32').config
    table = {name: fl for name, fl, _ in flops.conv_table(cfg)}
    fwd = sum(table.values())
    # every filter gradient, every input gradient but the images'
    assert flops.train_per_frame(cfg, 1) == pytest.approx(
        3 * fwd - table['conv_1'])
    joint = cells.cell('joint_train_b4').config
    rows = {name: fl for name, fl, _ in flops.conv_table(joint)}
    want = 3 * sum(rows.values()) - rows['conv_1'] - rows['recurrent'] / 4
    assert flops.train_per_frame(joint, 4) == pytest.approx(want)


def test_nms_bound_at_the_path_shape():
    # F=32 frames of K=128 candidates and 12 classes: 458,752 bytes bound
    # it until enough boxes are kept that the walk's rounds add up
    assert flops.nms_bound_s(0, 32, 128, 12) == pytest.approx(
        458752 / 3.35e12)
    kept = 20000
    assert flops.nms_bound_s(kept, 32, 128, 12) == pytest.approx(
        (32 * 128 * 128 * 14 + kept * 128 * 3) / 67e12)
