"""Serve verb `serve_engine`: the port's transformer serving engine over
the inputs' weights, kept as `session.served`.

  {"verb": "serve_engine", "cache_len": n, "max_batch": n}
"""

from repro_torch.serving.engine import Engine


def serve(session, spec: dict, seed: int) -> None:
    lm = session.inputs
    session.served = Engine(lm.cfg, lm.params, cache_len=spec["cache_len"],
                            max_batch=spec["max_batch"], seed=seed, device=session.device)
