"""Mish kernel for Hopper: wrapper, launch plan, plain twin, launch count.

Replaces no TPU kernel: the JAX package writes Mish as three jnp ops
(`object_tracking_tpu/models/darknet_cfg.py::_activate`), which XLA fuses
into one loop. Eager PyTorch runs the same expression as three kernels
over device memory (softplus, tanh, the product: 28 B an element in
float32), so `csrc/mish.cu` computes it in one pass that reads x once and
writes y once (8 B an element). Its header says what bounds it on the H100
(bytes) and how the design answers that (16-byte vectors, several loads in
flight a thread, a grid that covers the tensor in one wave of blocks).

`mish` goes through the custom op `ott_torch::mish` (`mish_op`): on a CPU
tensor it runs `mish_plain`, the eager expression; on a CUDA tensor it
launches the kernel (float32 or bfloat16; any other type raises), which
equals the eager expression bit for bit. Where a gradient is wanted it
goes through `MishFunction`, whose backward is plain PyTorch from the
saved input. `launch_plan` chooses every size of a launch in plain Python
that the CPU tests reach.
"""

from __future__ import annotations

import ctypes
import functools

import torch
import torch.nn.functional as F

from object_tracking_tpu_torch.utils.profiling import count

# The kernel's own constants (csrc/mish.cu; tests/test_torch_mish.py holds
# these copies equal to them)
THREADS = 128         # kThreads: a block
UNROLL = 2            # kUnroll: vectors in flight a thread
MAX_BLOCKS = 2**31 - 1   # the launch limit of a grid's x dimension
VECTOR_BYTES = 16
DTYPES = {torch.float32: 0, torch.bfloat16: 1}   # the launcher's codes

_fn = None


def mish_plain(x: torch.Tensor) -> torch.Tensor:
    """Mish as eager PyTorch: x · tanh(softplus(x)), softplus at beta 1
    and threshold 20. The kernel's function, and what CPU tensors run."""
    return x * torch.tanh(F.softplus(x))


def mish_grad_plain(x: torch.Tensor, grad: torch.Tensor) -> torch.Tensor:
    """The gradient of `mish_plain` at x: grad · (t + x·(1 − t²)·σ(x))
    with t = tanh(softplus(x)), in the operations and order autograd
    takes through the eager expression (the product's two branches, then
    tanh's and softplus' own backward ops), so it equals that gradient
    bit for bit."""
    t = torch.tanh(F.softplus(x))
    through_tanh = torch.ops.aten.tanh_backward(grad * x, t)
    return grad * t + torch.ops.aten.softplus_backward(through_tanh, x,
                                                       1.0, 20.0)


def _check(dtype: torch.dtype) -> None:
    if dtype not in DTYPES:
        raise TypeError(f'the mish kernel takes float32 or bfloat16, got '
                        f'{dtype}')


def _is_dense(x: torch.Tensor) -> bool:
    """Whether x's elements fill its storage span in some memory format:
    the kernel runs over that span, and `empty_like` keeps the format."""
    return x.is_contiguous() or (x.dim() == 4 and x.is_contiguous(
        memory_format=torch.channels_last))


def _dense(x: torch.Tensor) -> torch.Tensor:
    return x if _is_dense(x) else x.contiguous()


@functools.lru_cache(maxsize=256)
def launch_plan(numel: int, dtype: torch.dtype, aligned: bool = True
                ) -> dict:
    """Every size of one launch over `numel` elements of `dtype`: 16-byte
    vectors (`vec` elements each) where both pointers are 16-byte
    `aligned`, else single elements (`vec` 1); the `tail` of elements past
    the last vector, done by block 0; and the grid, one block for each
    THREADS·UNROLL units (`csrc/mish.cu` says why not fewer that stride).
    Cached per shape, since every launch asks for it: treat the dict as
    read-only."""
    _check(dtype)
    vec = VECTOR_BYTES // dtype.itemsize if aligned else 1
    units = numel // vec
    blocks = min(MAX_BLOCKS, max(1, -(-units // (THREADS * UNROLL))))
    return {'vec': vec, 'units': units, 'tail': numel - units * vec,
            'blocks': blocks if numel else 0}


def _launcher():
    global _fn
    if _fn is None:
        from object_tracking_tpu_torch.ops.cuda import _build
        fn = _build.load('mish').mish_launch
        fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong,
                       ctypes.c_int, ctypes.c_int, ctypes.c_int,
                       ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _fn = fn
    return _fn


def _launch(x: torch.Tensor) -> torch.Tensor:
    """One launch on a CUDA tensor, on the current stream, counted in
    `mish.launches`; raises on a failed build or launch."""
    x = _dense(x)
    out = torch.empty_like(x)
    n = x.numel()
    if n == 0:
        return out
    aligned = (x.data_ptr() | out.data_ptr()) % VECTOR_BYTES == 0
    plan = launch_plan(n, x.dtype, aligned)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = _launcher()(x.data_ptr(), out.data_ptr(), n, DTYPES[x.dtype],
                          plan['vec'], plan['blocks'], stream)
    if err != 0:
        raise RuntimeError(f'mish kernel launch failed: cudaError {err}')
    mish.launches += 1
    return out


# The kernel as the custom op `ott_torch::mish`, so that a traced program
# records one call of it and a profiler files its kernel under the op: the
# CUDA implementation launches the kernel, the CPU one runs the plain
# twin, and the fake one gives tracing the output's shape. Registering
# builds nothing; the kernel builds at its first launch.
@torch.library.custom_op('ott_torch::mish', mutates_args=(),
                         device_types='cuda')
def mish_op(x: torch.Tensor) -> torch.Tensor:
    _check(x.dtype)
    return _launch(x)


@mish_op.register_kernel('cpu')
def _mish_cpu(x: torch.Tensor) -> torch.Tensor:
    return mish_plain(_dense(x))


@mish_op.register_fake
def _mish_fake(x: torch.Tensor) -> torch.Tensor:
    if x.device.type == 'cuda':
        _check(x.dtype)
    return torch.empty_like(x, memory_format=torch.preserve_format
                            if _is_dense(x) else torch.contiguous_format)


class MishFunction(torch.autograd.Function):
    """Mish with a gradient: forward the op (the kernel on CUDA, the twin
    on the CPU), backward `mish_grad_plain` from the saved input."""

    @staticmethod
    def forward(ctx, x: torch.Tensor) -> torch.Tensor:
        ctx.save_for_backward(x)
        return torch.ops.ott_torch.mish(x)

    @staticmethod
    def backward(ctx, grad: torch.Tensor) -> torch.Tensor:
        x, = ctx.saved_tensors
        return mish_grad_plain(x, grad)


def mish(x: torch.Tensor) -> torch.Tensor:
    """Mish, x · tanh(softplus(x)), elementwise; the output has x's shape.

    CPU tensors run `mish_plain`; CUDA tensors (float32 or bfloat16, else
    TypeError) launch `csrc/mish.cu` once, counted in `mish.launches`.
    Where x requires grad and grad is enabled the call goes through
    `MishFunction`. Counts (`utils/profiling.count`, with a recorder
    attached) the elements as `mish.elements` and those the kernel
    computed as `mish.kernel_elements`.
    """
    if x.requires_grad and torch.is_grad_enabled():
        out = MishFunction.apply(x)
    else:
        out = torch.ops.ott_torch.mish(x)
    n = x.numel()
    count('mish.elements', n)
    count('mish.kernel_elements', n if x.is_cuda else 0)
    return out


mish.launches = 0
