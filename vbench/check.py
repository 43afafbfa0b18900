"""The comparison that decides `correct`.

The tap (`vbench.tap`) holds, for each sweep of the tapped requests, the
state that went in, the noise key and the state that came out. The program
is followed sweep by sweep from its own state: the reference
(`vbench.reference`) recomputes each sweep's z from the state that went in
and its key, and rebuilds the counts of each state that came out from that
state's own z. Apart from that, what the tap skips is checked by itself:
that each state is the one the sweep before it left (the chain), that each
chain starts from the state the request was handed and ends in the state
the request returned (for a batch, each product's state after the batch
engine unstacked it), that each product saw as many sweeps as the request
asked for, and that no noise key was used twice.

The numbers, each held to its limit (`limits` in the cell's file):

  z_mismatch      live tokens, over the checked sweeps, whose new topic
                  differs from the reference's, leaving out the reference's
                  near-ties (a margin under TIE: the top two perturbed
                  scores, or an MH round's accept or proposal test, closer
                  than that), where an ulp decides
  count_dev       the largest count deviation (`reference.counts.deviation`)
                  over the chains' first and every later state, and each
                  returned product state
  sweeps_missing  sweeps a product lacked or had beyond those asked for
  chain_breaks    states that are not the one before them left, or not the
                  one handed in or returned
  keys_repeated   noise keys (seed, offset) that a model used twice
  z_out_of_range  live tokens with a topic outside [0, K)
  unchecked       tapped requests that never ran or had no sweep

With `control`, the reference in bfloat16 stands in the program's place:
each checked sweep's z and each rebuild come from it.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from vbench.reference import alias as ref_alias
from vbench.reference import counts as ref_counts
from vbench.reference import gibbs as ref_gibbs
from vbench.reference import philox as ref_philox

CONTROL_DTYPE = torch.bfloat16
#: A reference decision closer than this is a near-tie (a few float32 ulps
#: of a score of tens).
TIE = 1e-5
EXACT = ("z_mismatch", "sweeps_missing", "chain_breaks", "keys_repeated", "z_out_of_range", "unchecked")


@dataclasses.dataclass
class Product:
    """One model a tapped request served: its corpus, and the state the
    request handed it (None for a cold fit) and returned."""

    cfg: object
    corpus: object
    start: Optional[object]
    final: object


def _i64(x: int) -> int:
    return x - (1 << 64) if x >= 1 << 63 else x


def _stack(x):
    return type(x)(*(getattr(x, f.name)[None] for f in dataclasses.fields(x)))


def _stacked(rec):
    if rec.entry == "many":
        return rec.corpus, rec.state_in, rec.state_out
    return _stack(rec.corpus), _stack(rec.state_in), _stack(rec.state_out)


def _noise_fn(rec, shape):
    """`noise(start, stop, dtype)` of the sweep, from its key."""
    kind, m, (n, k) = rec.key[0], shape[0], shape[1:]
    dev = rec.state_in.z.device
    if kind in ("philox", "philox_table"):
        if kind == "philox":
            seed = torch.tensor([_i64(rec.key[1])], dtype=torch.int64, device=dev)
            offset = torch.tensor([_i64(rec.key[2])], dtype=torch.int64, device=dev)
        else:
            seed, offset = rec.key[1][:, 0].to(dev), rec.key[1][:, 1].to(dev)
        return lambda a, b, dtype: ref_philox.gibbs_noise(seed, offset, a, b, k, dtype)
    if kind == "noise":
        full = rec.key[1].reshape(m, n, k)
    else:  # "cpu_rand": the CPU sweep's torch.rand uniforms from the generator's state
        gen = torch.Generator()
        gen.set_state(rec.key[1])
        u = torch.rand((n, k), generator=gen, dtype=torch.float32)
        full = u.clamp_min_(ref_philox.TINY).log_().neg_().log_().neg_()[None]
    return lambda a, b, dtype: full[:, a:b].to(dtype)


def _alias_draws(rec, n, k):
    """`draws(start, stop)` of an alias sweep, from its key."""
    dev = rec.state_in.z.device
    if rec.key[0] == "philox":
        seed, offset = _i64(rec.key[1]), _i64(rec.key[2])
        return lambda a, b: ref_alias.philox_draws(seed, offset, a, b, rec.rounds, k, dev)
    gen = torch.Generator()  # "cpu_rand": the CPU sweep's draws from the generator's state
    gen.set_state(rec.key[1])
    j = torch.randint(0, k, (rec.rounds, n), generator=gen, dtype=torch.int32)
    u_prop = torch.rand((rec.rounds, n), generator=gen)
    u_acc = torch.rand((rec.rounds, n), generator=gen)
    return lambda a, b: (j[:, a:b], u_prop[:, a:b], u_acc[:, a:b])


def _resample(rec, corpus, state, dtype):
    cfg = rec.cfg
    scale = 1.0 if cfg.w_bits is None else 2.0 ** -(cfg.w_bits + 1)
    if rec.entry == "alias":
        c, s = corpus, state
        z, margin = ref_alias.resample(
            c.docs[0], c.words[0], s.z[0], c.weights[0], s.n_dt[0], s.n_wt[0], s.n_t[0],
            _alias_draws(rec, c.docs.shape[-1], cfg.num_topics), alpha=cfg.alpha,
            beta=cfg.beta, beta_bar=cfg.beta * cfg.vocab_size, scale=scale, dtype=dtype)
        return z[None], margin[None]
    return ref_gibbs.resample(
        corpus.docs, corpus.words, state.z, corpus.weights, state.n_dt, state.n_wt, state.n_t,
        _noise_fn(rec, corpus.docs.shape + (cfg.num_topics,)), alpha=cfg.alpha, beta=cfg.beta,
        beta_bar=cfg.beta * cfg.vocab_size, scale=scale, dtype=dtype)


def _rebuild(cfg, corpus, z, dtype=torch.float64):
    return ref_counts.rebuild(corpus.docs, corpus.words, z, corpus.weights, cfg.num_docs,
                              cfg.vocab_size, cfg.num_topics, dtype)


def _count_dev(cfg, corpus, state, control: bool) -> float:
    ref = _rebuild(cfg, corpus, state.z)
    if control:  # the control's own rebuild, stored as the program stores
        low = _rebuild(cfg, corpus, state.z, CONTROL_DTYPE)
        state = type(state)(state.z, *(ref_counts.encode(low[k], cfg.w_bits)
                                       for k in ("n_dt", "n_wt", "n_t")))
    return ref_counts.deviation(state, ref, cfg.w_bits)


def _same(a, b) -> bool:
    return all(torch.equal(getattr(a, f.name), getattr(b, f.name))
               for f in dataclasses.fields(a))


def _signature(docs, words, weights) -> list[tuple]:
    """Per row: (live tokens, a position-weighted sum of its words and docs)."""
    live = weights > 0
    pos = torch.arange(1, docs.shape[-1] + 1, device=docs.device)
    mix = torch.where(live, words.long() * 7919 + docs.long(), 0) * pos
    return list(zip(live.sum(-1).tolist(), mix.sum(-1).tolist()))


def _row_of(products, corpus) -> dict[int, int]:
    """Which product each row of a (stacked) corpus holds: row -> index."""
    by_sig = {}
    for i, p in enumerate(products):
        c = p.corpus
        by_sig.setdefault(_signature(c.docs[None], c.words[None], c.weights[None])[0], []).append(i)
    rows = {}
    for j, sig in enumerate(_signature(corpus.docs, corpus.words, corpus.weights)):
        for i in by_sig.get(sig, ()):
            c, n = products[i].corpus, products[i].corpus.num_tokens
            if (torch.equal(corpus.docs[j, :n], c.docs) and torch.equal(corpus.words[j, :n], c.words)
                    and torch.equal(corpus.weights[j, :n], c.weights)):
                rows[j] = i
                break
    return rows


def _bad(z, k, live) -> torch.Tensor:
    return ((z < 0) | (z >= k)) & live


def _out_of_range(z, k, live, out) -> bool:
    bad = _bad(z, k, live)
    out["z_out_of_range"] += int(bad.sum())
    return bool(bad.any())


def _check_start(rec, rows, products, out) -> None:
    """The state a chain starts from: topics in range, counts that are its
    own rebuild, and the state the request was handed."""
    corpus, s_in, _ = _stacked(rec)
    if _out_of_range(s_in.z, rec.cfg.num_topics, corpus.weights > 0, out):
        return
    out["count_dev"] = max(out["count_dev"], _count_dev(rec.cfg, corpus, s_in, False))
    for j, i in rows.items():
        start, n = products[i].start, products[i].corpus.num_tokens
        if start is not None and not torch.equal(s_in.z[j, :n], start.z):
            out["chain_breaks"] += 1


def _count_keys(rec, rows, keys: set, out) -> None:
    """Each model's (seed, offset) is fresh."""
    if rec.key[0] == "philox":
        used = [(_i64(rec.key[1]), _i64(rec.key[2]))]
    elif rec.key[0] == "philox_table":
        table = rec.key[1].tolist()
        used = [tuple(table[j]) for j in rows]
    else:  # injected noise or a CPU generator's state: nothing to reuse
        used = []
    for key in used:
        out["keys_repeated"] += key in keys
        keys.add(key)


def _check_sweep(rec, control: bool, out) -> None:
    """One sweep: its z against the reference's from the state that went
    in, and its counts against their rebuild from that z."""
    corpus, s_in, s_out = _stacked(rec)
    live = corpus.weights > 0
    if bool(_bad(s_in.z, rec.cfg.num_topics, live).any()):  # counted where it came out
        return
    ref_z, margin = _resample(rec, corpus, s_in, torch.float32)
    got_z = _resample(rec, corpus, s_in, CONTROL_DTYPE)[0] if control else s_out.z
    out["z_mismatch"] += int(((got_z != ref_z) & live & (margin >= TIE)).sum())
    del ref_z, margin
    if _out_of_range(got_z, rec.cfg.num_topics, live, out):
        return
    state = type(s_out)(got_z, s_out.n_dt, s_out.n_wt, s_out.n_t)
    out["count_dev"] = max(out["count_dev"], _count_dev(rec.cfg, corpus, state, control))


def _check_finals(rec, rows, products, control: bool, out) -> None:
    """Each product's returned state (for a batch, as the batch engine
    unstacked it): the chain's last z, and counts that are its rebuild."""
    last = _stacked(rec)[2]
    for j, i in rows.items():
        p, n = products[i], products[i].corpus.num_tokens
        if not torch.equal(last.z[j, :n], p.final.z):
            out["chain_breaks"] += 1
            continue
        out["count_dev"] = max(out["count_dev"], _count_dev(
            p.cfg, _stack(p.corpus), _stack(p.final), control))


def check(records, requests: dict[int, list[Product]], sweeps: int,
          control: bool = False) -> dict[str, float]:
    """The numbers of the tapped `requests` (index -> the products it
    served), each of which asked for `sweeps` sweeps a product."""
    out = dict.fromkeys(("count_dev",) + EXACT, 0.0)
    keys: set = set()  # the (seed, offset) of every model's checked sweeps
    for req, products in requests.items():
        chains: dict[int, list] = {}  # one a stacked corpus, in the order run
        for rec in records:
            if rec.request == req:
                chains.setdefault(id(rec.corpus), []).append(rec)
        if not chains:
            out["unchecked"] += 1
            continue
        seen = [0] * len(products)
        for chain in chains.values():
            rows = _row_of(products, _stacked(chain[0])[0])
            for i in rows.values():
                seen[i] += len(chain)
            _check_start(chain[0], rows, products, out)
            for s, rec in enumerate(chain):
                if s and not _same(rec.state_in, chain[s - 1].state_out):
                    out["chain_breaks"] += 1
                _count_keys(rec, rows, keys, out)
                _check_sweep(rec, control, out)
            _check_finals(chain[-1], rows, products, control, out)
        out["sweeps_missing"] += sum(abs(n - sweeps) for n in seen)
    return out


def verdict(numbers: dict[str, float], limits: dict[str, float]) -> tuple[bool, dict]:
    """(every number within its limit, {name: {"value", "limit"}}); the
    exact counts take the limit 0."""
    table, ok = {}, True
    for name, value in numbers.items():
        limit = limits.get(name, 0.0) if name not in EXACT else 0.0
        table[name] = {"value": value, "limit": limit}
        ok = ok and value <= limit
    return ok, table
