"""Growth (``core/activation.py``): wall ms a frame in the growth pass,
``expand_for_state`` as ``run_plume`` calls it, over the timed frames:
each call from a synchronize before it (so that the frame's step is not
counted) to one after it (so that its own device work is)."""

NEEDS = "timed"
FUNCTION = ("hnanosolver_tpu_torch.models.plume", "expand_for_state")


def read(run):
    rec = run.rec
    calls = rec.timed.get(".".join(FUNCTION))
    if not calls or not rec.timed_frames:
        return None
    return sum(calls) * 1e3 / rec.timed_frames
