"""Device timers of the port's measurements on the card.

``device_ms`` times a call's device work with CUDA events around calls
queued behind a spin kernel; ``profiled_ms`` takes the profiler's kernel
sum, for calls that wait on the device or fill the launch queue;
``call_ms`` times a call with its launch and host work.  Each device time
is an ``Ms``, a float in ms that names its method.  They need a CUDA card;
``chip_smoke.py`` and the micro-benchmarks of this package use them.
"""

from __future__ import annotations

import statistics
import time

import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile


def call_ms(fn, n=30, warmup=5):
    """Median time of one fn() call in ms: CUDA events around each call,
    so host work inside the call (launch overhead, host syncs) counts."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(n):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


class Ms(float):
    """A device time in ms and the method that took it: "events" (CUDA
    events around calls queued behind a spin kernel) or "profiler" (the
    profiler's kernel sum)."""

    def __new__(cls, ms, method):
        t = super().__new__(cls, ms)
        t.method = method
        return t


def mean_ms(times):
    """The mean of Ms times, keeping their methods ("events+profiler"
    where they differ)."""
    return Ms(sum(times) / len(times),
              "+".join(sorted({t.method for t in times})))


_SPIN = {}


def spin_cycles_per_ms():
    """The clock cycles torch.cuda._sleep spins per ms on this card."""
    if "cycles" not in _SPIN:
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        torch.cuda.synchronize()
        start.record()
        torch.cuda._sleep(10**7)
        end.record()
        end.synchronize()
        _SPIN["cycles"] = 1e7 / start.elapsed_time(end)
    return _SPIN["cycles"]


def device_ms(fn, n=20, warmup=3):
    """Device time of one fn() call in ms: CUDA events around n calls
    that the host enqueues behind a spin kernel (torch.cuda._sleep), so
    the device runs them back to back and the host's launch overhead is
    hidden.  The gaps between queued kernels count, idle time does not.
    The spin lasts twice the host's time to enqueue n calls (from the
    warm-up) plus 1 ms; a run in which the spin ended before the host had
    enqueued the n calls is taken again with a spin four times as long.
    If that fails too (fn waits on the device, or its launches fill the
    device's launch queue, as a plain twin of hundreds of small kernels
    does), the time is ``profiled_ms``'s kernel sum.  Returns an Ms
    that names its method.  A first call, untimed, builds or loads what
    fn needs, so that a build does not set the spin's length."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(warmup):
        fn()
    spin_ms = 2 * n * (time.perf_counter() - t0) * 1e3 / warmup + 1.0
    torch.cuda.synchronize()
    for _ in range(2):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(int(spin_ms * spin_cycles_per_ms()))
        start.record()
        for _ in range(n):
            fn()
        end.record()
        queued = not start.query()   # the spin still ran: nothing idled
        end.synchronize()
        if queued:
            return Ms(start.elapsed_time(end) / n, "events")
        spin_ms *= 4
    print(f"  (the host could not enqueue {n} calls within a "
          f"{spin_ms / 4:.1f} ms spin; timed by the profiler)")
    return profiled_ms(fn, n, warmup=1)


def profiled_ms(fn, n=20, warmup=3):
    """Device time of one fn() call in ms for an fn that waits on the
    device (a host loop): the kernel and copy times the profiler records
    over n calls, per call.  A profile may lose a few device items at
    its edges: the time per call is then the mean item time times the
    items per call (the count over n, rounded).  A profile with no
    items, or with a count more than 10% away from that many per call
    (a lost or mixed trace), is taken again, at most three times in all,
    and then raises.  Only device activity is recorded: the host's ops
    of a host loop of thousands of launches would cost seconds a profile
    and add nothing to the kernel sum.  Returns an Ms of method
    "profiler"."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    for attempt in range(3):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(n):
                fn()
            torch.cuda.synchronize()
        items = [e for e in prof.key_averages()
                 if e.device_type == DeviceType.CUDA]
        us = sum(e.self_device_time_total for e in items)
        count = sum(e.count for e in items)
        per_call = round(count / n)
        if us > 0 and per_call > 0 and (
                abs(count - per_call * n) <= 0.1 * per_call * n):
            return Ms(us / count * per_call / 1e3, "profiler")
        print(f"  (profile {attempt + 1} recorded {count} device items, "
              f"{us:.1f} us, for {n} calls; taken again)")
    raise AssertionError(f"the profiler lost the trace in three profiles "
                         f"of {n} calls")
