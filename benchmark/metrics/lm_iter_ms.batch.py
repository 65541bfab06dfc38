"""lm_iter_ms.batch: device milliseconds of the captured LM program's
iteration phase per LM iteration executed, in the traced slice: the time in
which a device operation ran inside the device-side range the profiler
records for the phase's host range (``device_loop.Program.run`` names it
``<program>.iterate``), over the slice's iterations. The profiler slows the
graphs' launches, so the range itself holds waits the unprofiled program
does not have; its busy time is the phase's device time. Nothing when the
trace holds no such range."""

PHASE = "lm_ndchol_fused_chordal.iterate"


def read(run):
    if run.trace is None:
        return None
    seconds = run.trace.annotation_busy_s(PHASE)
    iters = sum(r["iterations"] for r in run.traced)
    if seconds is None or iters == 0:
        return None
    return 1e3 * seconds / iters
