"""`repro_torch.api` — the client/server protocol for topic-model inference.

The device-facing API is the versioned wire protocol, identical to the
reference package's (a client of either package drives a server of the
other):

    from repro_torch.api import VedaliaClient

    client = VedaliaClient(backend="cuda")        # in-process server, on the card
    res = client.fit(reviews, num_topics=12)      # -> FitResult(handle_id)
    client.update(res.handle_id, new_reviews)
    sync = client.sync_view(res.handle_id)        # full view + cursor
    sync = client.sync_view(res.handle_id)        # delta: only drifted topics

Servers run on CUDA unless given ``device="cpu"``.

Submodules:
  codec     stored-state codec + wire array codec
  backends  `Sampler` protocol + capability-aware registry
            (torch / cuda / alias / batched, `auto` selector, `jnp` /
            `pallas` aliases)
  service   `VedaliaService` facade + typed request/response dataclasses
  protocol  versioned JSON envelopes (requests, responses, tensor codec)
  server    `VedaliaServer`: sessions, view cursors, wire dispatch
  client    `VedaliaClient`: thin typed client over any string transport

Exports resolve lazily (PEP 562), so importing the package loads no
submodule until a name is used.
"""

from __future__ import annotations

import importlib

_EXPORTS = {
    # backends
    "Sampler": "repro_torch.api.backends",
    "SamplerCapabilities": "repro_torch.api.backends",
    "available_backends": "repro_torch.api.backends",
    "backend_capabilities": "repro_torch.api.backends",
    "get_backend": "repro_torch.api.backends",
    "register_backend": "repro_torch.api.backends",
    "select_backend": "repro_torch.api.backends",
    # service
    "FitRequest": "repro_torch.api.service",
    "ModelHandle": "repro_torch.api.service",
    "SpotCheckResponse": "repro_torch.api.service",
    "TopReviewsResponse": "repro_torch.api.service",
    "UpdateResponse": "repro_torch.api.service",
    "VedaliaService": "repro_torch.api.service",
    "ViewResponse": "repro_torch.api.service",
    # protocol / server / client
    "PROTOCOL_VERSION": "repro_torch.api.protocol",
    "ProtocolError": "repro_torch.api.protocol",
    "RemoteError": "repro_torch.api.protocol",
    "Overloaded": "repro_torch.api.protocol",
    "VedaliaServer": "repro_torch.api.server",
    "VedaliaClient": "repro_torch.api.client",
    "FitResult": "repro_torch.api.client",
    "ExportedModel": "repro_torch.api.client",
    "SpotCheckResult": "repro_torch.api.client",
    "IngestResult": "repro_torch.api.client",
    "PrepareResult": "repro_torch.api.client",
    "ServerInfo": "repro_torch.api.client",
    "StatsResult": "repro_torch.api.client",
    "UpdateResult": "repro_torch.api.client",
    "ViewResult": "repro_torch.api.client",
    "TopReviewsResult": "repro_torch.api.client",
    # module-level re-exports
    "codec": "repro_torch.api.codec",
    "protocol": "repro_torch.api.protocol",
}

__all__ = sorted(_EXPORTS)


def __getattr__(name: str):
    target = _EXPORTS.get(name)
    if target is None:
        raise AttributeError(f"module 'repro_torch.api' has no attribute {name!r}")
    module = importlib.import_module(target)
    value = module if target.endswith("." + name) else getattr(module, name)
    globals()[name] = value
    return value


def __dir__():
    return __all__
