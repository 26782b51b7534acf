"""Growth (``core/activation.py``): the share of activation passes whose
rebuilt topology equalled the old one and was thrown away, in %: 100 x the
program's counts ``grow.discarded`` / ``grow.passes``, over every pass of
the run (set-up's warm cook and the window's cooks alike; ``program_spans.py``)."""

import program_spans as spans

NEEDS = "trace"

MODULE = "hnanosolver_tpu_torch.core.activation"


def read(run):
    passes, discarded = spans.count(MODULE, "passes"), spans.count(MODULE, "discarded")
    if not passes or discarded is None:
        return None
    return 100.0 * discarded / passes
