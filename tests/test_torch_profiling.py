"""The port's stack sampler against the reference's: the same sweeps record
the same stack for a thread waiting in each package's own code, and the
port's sweep leaves no cycle behind while the reference's does.

A sweep holds ``sys._current_frames()`` in a local; the snapshot includes
the sampler's own frame, so unless that frame leaves it the sweep closes a
cycle (the frame → its ``frames`` local → the frame) that keeps every
thread's stack and locals alive until the cyclic collector runs. The port
drops its own frame from the snapshot; the reference keeps it
(``ROADMAP.md`` §C, fault 3)."""

import gc
import types

import pytest

from dragonfly2_torch.utils import gc as t_gc
from dragonfly2_torch.utils import profiling as t_prof
from dragonfly2_tpu.utils import gc as j_gc
from dragonfly2_tpu.utils import profiling as j_prof

PACKAGES = {"port": (t_prof, t_gc), "ref": (j_prof, j_gc)}


def _sweeps(pkg, n=5):
    """``n`` sweeps of a fresh sampler while one interval-GC thread of the
    package waits in its loop → (stacks recorded per sweep, the stacks in
    the sampler's ring, the sweeps' own frames the collector then found
    in cycles). Other threads of the process may be sampled too."""
    prof, gcmod = PACKAGES[pkg]
    runner = gcmod.GC()
    runner.add(gcmod.GCTask("idle", 3600.0, 1.0, lambda: None))
    sampler = prof.SamplingProfiler(hz=1)
    runner.start()
    gc.collect()
    gc.disable()
    gc.set_debug(gc.DEBUG_SAVEALL)
    try:
        recorded = [sampler.sample_once() for _ in range(n)]
        gc.collect()
        own = sum(
            1 for o in gc.garbage
            if isinstance(o, types.FrameType) and o.f_code is prof.SamplingProfiler.sample_once.__code__
        )
    finally:
        gc.set_debug(0)
        gc.garbage.clear()
        gc.enable()
        runner.stop()
    return recorded, {tup for _, _, tup in sampler._ring}, own


@pytest.mark.parametrize("pkg", ["port", "ref"])
def test_sweeps_record_the_waiting_thread(pkg):
    recorded, stacks, _ = _sweeps(pkg)
    assert all(r >= 1 for r in recorded)
    assert ("utils.gc._loop",) in stacks


def test_port_sweep_leaves_no_cycle():
    assert _sweeps("port")[2] == 0


def test_reference_sweep_leaves_a_cycle_each():
    # the fault the port does not copy: each sweep's frame outlives it (a
    # sampler the process runs in the background may add its own)
    assert _sweeps("ref")[2] >= 5
