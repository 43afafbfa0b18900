"""Request verb `refine`: every served model refined in turn.

  {"verb": "refine", "sweeps": n}
"""

from vbench.check import Product
from vbench.loop import Done


def issue(session, spec: dict, seed: int, keep: bool) -> Done:
    sweeps = spec["sweeps"]
    before = [h.model.state for h in session.handles]
    for i, h in enumerate(session.handles):
        session.service.refine(h, sweeps, seed=seed + i)
    kept = ([Product(h.cfg, h.model.corpus, s, h.model.state)
             for h, s in zip(session.handles, before)] if keep else None)
    return Done(sweeps, sweeps * session.live_tokens, 0, kept)
