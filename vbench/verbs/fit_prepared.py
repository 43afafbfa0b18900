"""Serve verb `fit_prepared`: one model fitted a product, kept as the
session's handles.

  {"verb": "fit_prepared", "backend": name, "sweeps": n}
"""


def serve(session, spec: dict, seed: int) -> None:
    session.handles = [
        session.service.fit_prepared(p, backend=spec["backend"], num_sweeps=spec["sweeps"],
                                     seed=seed + i)
        for i, p in enumerate(session.inputs)]
