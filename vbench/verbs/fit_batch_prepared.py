"""Request verb `fit_batch_prepared`: a wave that fits every input in one
batched call, then releases the wave's handles (else they pile up in the
service).

  {"verb": "fit_batch_prepared", "backend": name, "sweeps": n}
"""

from vbench.check import Product
from vbench.loop import Done


def issue(session, spec: dict, seed: int, keep: bool) -> Done:
    sweeps = spec["sweeps"]
    handles = session.service.fit_batch_prepared(
        session.inputs, backend=spec["backend"], num_sweeps=sweeps, seed=seed)
    kept = [Product(h.cfg, h.model.corpus, None, h.model.state) for h in handles] if keep else None
    for h in handles:
        session.service.release(h)
    return Done(sweeps, sweeps * session.live_tokens, len(handles), kept)
