"""Codec-based snapshot/restore of a `VedaliaServer` shard.

A killed shard must come back owning exactly the models it owned before:
same handle ids (clients hold them), same stored-unit sampler state (the
fixed-point codec means bit-exact counts), same prepared corpora, and the
same ingest queues and ack cursors (acked reviews are durable — a crash
between ack and apply loses nothing).

What is *deliberately not* snapshotted: sessions and their view cursors.
They are soft state — a client whose session died resyncs through the
existing recovery path in `VedaliaClient.view` (unknown session → reopen →
full view flagged `resync`). That keeps snapshots small and the recovery
story single-pathed.

Everything rides the wire codecs of `repro_torch.api.protocol` (b64 raw
tensors, review dicts), so `snapshot_server(restore_server(snap)) == snap`
holds as plain dict equality — the codec-level round-trip gate of the
stream subsystem. The format is framework-neutral: it is the reference
package's, so a snapshot of either package's server restores into the
other's. A restored server holds its tensors on its own device (CUDA unless
``device="cpu"``); `quant`, a packed `QuantSpec` included, rides in each
config, so a restored packed-spec handle refits on the packed path.
"""

from __future__ import annotations

import dataclasses
import json

import torch

from repro_torch.api import protocol
from repro_torch.api.server import VedaliaServer
from repro_torch.api.service import ModelHandle, VedaliaService
from repro_torch.core import rlda, update
from repro_torch.core.quant import QuantSpec
from repro_torch.core.types import Corpus, LDAConfig, LDAState
from repro_torch.device import DeviceLike

SNAPSHOT_FORMAT = 1

_PREP_ARRAYS = ("psi", "tiers", "tier_probs", "ratings", "helpful",
                "unhelpful")


def _encode_cfg(cfg: LDAConfig) -> dict:
    return dataclasses.asdict(cfg)


def _decode_cfg(d: dict) -> LDAConfig:
    q = d.get("quant")
    return LDAConfig(
        num_topics=int(d["num_topics"]),
        vocab_size=int(d["vocab_size"]),
        num_docs=int(d["num_docs"]),
        alpha=float(d["alpha"]),
        beta=float(d["beta"]),
        w_bits=None if d["w_bits"] is None else int(d["w_bits"]),
        quant=None if q is None else QuantSpec(
            mode=q["mode"],
            w_bits=None if q["w_bits"] is None else int(q["w_bits"])),
    )


def _encode_prep(prep: rlda.RLDACorpus) -> dict:
    out = {
        "cfg": _encode_cfg(prep.cfg),
        "base_vocab": int(prep.base_vocab),
        "docs": protocol.encode_array(prep.corpus.docs),
        "words": protocol.encode_array(prep.corpus.words),
        "weights": protocol.encode_array(prep.corpus.weights),
    }
    for name in _PREP_ARRAYS:
        out[name] = protocol.encode_array(getattr(prep, name))
    return out


def _tensor(d: dict, device) -> torch.Tensor:
    """A wire array as a tensor on `device`, its dtype kept."""
    return torch.tensor(protocol.decode_array(d), device=device)


def _decode_prep(d: dict, device) -> rlda.RLDACorpus:
    return rlda.RLDACorpus(
        corpus=Corpus(
            docs=_tensor(d["docs"], device),
            words=_tensor(d["words"], device),
            weights=_tensor(d["weights"], device),
        ),
        cfg=_decode_cfg(d["cfg"]),
        base_vocab=int(d["base_vocab"]),
        **{name: protocol.decode_array(d[name]) for name in _PREP_ARRAYS},
    )


def _encode_state(state: LDAState) -> dict:
    return {
        name: protocol.encode_array(getattr(state, name))
        for name in ("z", "n_dt", "n_wt", "n_t")
    }


def _decode_state(d: dict, device) -> LDAState:
    return LDAState(**{
        name: _tensor(d[name], device) for name in ("z", "n_dt", "n_wt", "n_t")
    })


def _encode_handle(handle: ModelHandle) -> dict:
    # prep.corpus and model.corpus are the same object by construction
    # (fit/adopt share it; update replaces both), so the corpus is encoded
    # once, inside the prep.
    return {
        "handle_id": handle.handle_id,
        "backend": handle.backend,
        "sweeps_run": handle.sweeps_run,
        "updates_since_recompute": handle.model.updates_since_recompute,
        "full_recompute_every": handle.model.full_recompute_every,
        "prep": _encode_prep(handle.prep),
        "state": _encode_state(handle.state),
    }


def _decode_handle(d: dict, device) -> ModelHandle:
    prep = _decode_prep(d["prep"], device)
    model = update.UpdatableModel(
        cfg=prep.cfg,
        corpus=prep.corpus,
        state=_decode_state(d["state"], device),
        updates_since_recompute=int(d["updates_since_recompute"]),
        full_recompute_every=int(d["full_recompute_every"]),
    )
    return ModelHandle(
        handle_id=int(d["handle_id"]),
        prep=prep,
        model=model,
        backend=d["backend"],
        sweeps_run=int(d["sweeps_run"]),
    )


def snapshot_server(server: VedaliaServer) -> dict:
    """Full durable state of a shard as one JSON-serializable dict."""
    svc = server.service
    return {
        "format": SNAPSHOT_FORMAT,
        "config": {
            "max_cursors_per_session": server.max_cursors_per_session,
            "max_sessions": server.max_sessions,
            "max_ingest_queue": server.max_ingest_queue,
            "rel_mass_tol": server.rel_mass_tol,
            "weight_tol": server.weight_tol,
        },
        "service": {
            "default_backend": svc.default_backend,
            "num_sweeps": svc.num_sweeps,
            "update_sweeps": svc.update_sweeps,
            "backend_opts": svc._backend_opts,
            "seed": svc._seed,
            "op": svc._op,
            "next_handle_id": svc._next_id,
        },
        "handles": [
            _encode_handle(h) for _, h in sorted(svc.handles.items())
        ],
        "preps": {
            str(cid): _encode_prep(p)
            for cid, p in sorted(server.preps.items())
        },
        "next_corpus_id": server._next_corpus,
        # Sessions themselves are soft state, but the id counters are not:
        # a restored server that re-minted "s0"/"c0" could hand a pre-kill
        # client's stale cursor a *different* snapshot's delta and have it
        # silently accepted. Fresh ids keep every stale cursor a resync.
        "next_session_id": server._next_session,
        "next_cursor_id": server._next_cursor,
        "ingest": {
            str(hid): {
                "acked": server.ingest_acked.get(hid, 0),
                "queued": protocol.encode_reviews(
                    server.ingest_queues.get(hid, [])),
            }
            for hid in sorted(
                set(server.ingest_queues) | set(server.ingest_acked))
        },
    }


def restore_server(snap: dict, *, device: DeviceLike = None,
                   **overrides) -> VedaliaServer:
    """Rebuild a shard from a snapshot on `device` (CUDA unless
    ``device="cpu"``); `overrides` adjust server limits.

    Handle and corpus ids are restored verbatim, so clients holding them
    keep working; sessions start empty and clients resync on first view.
    """
    if snap.get("format") != SNAPSHOT_FORMAT:
        raise ValueError(
            f"unsupported snapshot format {snap.get('format')!r}; "
            f"this build reads format {SNAPSHOT_FORMAT}")
    svc_meta = snap["service"]
    service = VedaliaService(
        backend=svc_meta["default_backend"],
        num_sweeps=int(svc_meta["num_sweeps"]),
        update_sweeps=int(svc_meta["update_sweeps"]),
        backend_opts=svc_meta["backend_opts"],
        seed=int(svc_meta["seed"]),
        device=device,
    )
    service._op = int(svc_meta["op"])
    service._next_id = int(svc_meta["next_handle_id"])
    for d in snap["handles"]:
        handle = _decode_handle(d, service.device)
        service.handles[handle.handle_id] = handle

    server = VedaliaServer(service=service,
                           **{**snap["config"], **overrides})
    server.preps = {
        int(cid): _decode_prep(d, service.device)
        for cid, d in snap["preps"].items()
    }
    server._next_corpus = int(snap["next_corpus_id"])
    server._next_session = int(snap["next_session_id"])
    server._next_cursor = int(snap["next_cursor_id"])
    for hid, d in snap["ingest"].items():
        server.ingest_acked[int(hid)] = int(d["acked"])
        server.ingest_queues[int(hid)] = protocol.decode_reviews(d["queued"])
    return server


def snapshot_to_json(server: VedaliaServer) -> str:
    return json.dumps(snapshot_server(server))


def restore_from_json(raw: str, *, device: DeviceLike = None,
                      **overrides) -> VedaliaServer:
    return restore_server(json.loads(raw), device=device, **overrides)
