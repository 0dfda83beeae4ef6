"""Timing work on the card, and the least time it could take.

Used by ``chip_smoke.py`` and :mod:`tpushare_torch.profile_k1`.  Every
function here needs a CUDA device.
"""

from __future__ import annotations

import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

#: published dense peaks of one H100 SXM (NVIDIA data sheet): bf16 tensor
#: FLOP/s and HBM bytes/s, the two rates a kernel's bound is taken over
PEAK_BF16_FLOPS = 989e12
PEAK_HBM_BYTES = 3.35e12
#: how many times device_ms takes a profiler window that came back empty
#: or with launches lost
_WINDOW_ATTEMPTS = 3
#: the L2 flush's kernel names, from the process's first window that
#: showed them (every flush is l2_flush_buffer's uint8 zeroing)
_flush_names: set = set()


def l2_flush_buffer() -> torch.Tensor:
    """256 MB whose zeroing evicts the 50 MB L2."""
    return torch.empty(256 << 20, dtype=torch.uint8, device="cuda")


def event_ms(fn, iters: int, flush: torch.Tensor) -> float:
    """Mean time of ``fn`` over ``iters`` calls, each between its own CUDA
    events with the L2 flushed (outside them) before it, as a layer of the
    model finds it after the other layers' weights went through; after two
    warm-up calls.  Host time in the call's launch path before the device
    reaches the kernel counts too."""
    for _ in range(2):
        fn()
    total = 0.0
    for _ in range(iters):
        flush.zero_()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        total += start.elapsed_time(end)
    return total / iters


def _device_kernels(prof) -> dict:
    """{kernel name: [device us, launches]} of a profiled window."""
    out = {}
    for e in prof.key_averages():
        if e.device_type != DeviceType.CUDA or e.self_device_time_total <= 0:
            continue
        us, n = out.get(e.key, (0.0, 0))
        out[e.key] = [us + e.self_device_time_total, n + e.count]
    return out


def device_ms(fn, iters: int, flush: torch.Tensor):
    """The device time of one call of ``fn``: the summed durations of the
    kernels it launches, by ``torch.profiler``, mean over ``iters`` calls,
    each after the L2 is flushed (the flush's own kernels left out).
    Returns (ms, {kernel name: launches a call}).

    The profiler can lose the first kernel of a window (seen on an H100
    under torch 2.11 once a process had run a while: a window of one
    flush came back empty, and a window of three held two), so every
    window opens with flushes that it may lose: the flush's names come
    from a window of three, and the timed window has two before its
    first call; a kernel of the call seen a number of times that is not
    a multiple of ``iters`` raises.  A window that came back empty, or
    with launches lost, is taken again, up to ``_WINDOW_ATTEMPTS`` times
    (a window of three flushes once came back empty, three times running
    in one process: so the flush's names are taken once a process)."""
    for _ in range(_WINDOW_ATTEMPTS):
        if _flush_names:
            break
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(3):
                flush.zero_()
            torch.cuda.synchronize()
        _flush_names.update(_device_kernels(prof))
    if not _flush_names:
        raise RuntimeError("the profiler saw no kernel of the L2 flush")
    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    for _ in range(_WINDOW_ATTEMPTS):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(2):
                flush.zero_()
            for _ in range(iters):
                flush.zero_()
                fn()
            torch.cuda.synchronize()
        kernels = {k: v for k, v in _device_kernels(prof).items()
                   if k not in _flush_names}
        lost = {k: n for k, (_, n) in kernels.items() if n % iters}
        if kernels and not lost:
            break
    if not kernels:
        raise RuntimeError("the profiler saw no device kernel of the call")
    if lost:
        raise RuntimeError(f"the profiler lost launches of the call: {lost} "
                           f"in {iters} calls")
    total_us = sum(us for us, _ in kernels.values())
    return total_us / iters / 1e3, {k: n / iters for k, (_, n) in
                                    kernels.items()}


def bound_ms(flops: float, nbytes: float):
    """(ms, "operations" or "bytes"): the longer of ``flops`` at the bf16
    peak and ``nbytes`` at the HBM rate."""
    t_ops = flops / PEAK_BF16_FLOPS * 1e3
    t_bytes = nbytes / PEAK_HBM_BYTES * 1e3
    return max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes
                                 else "bytes")
