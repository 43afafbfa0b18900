"""Chital — the distributed computation marketplace (paper §2.5).

Five components, each mapped 1:1 to a module:
  marketplace.py   task distribution + buyer/seller lifecycle (§2.5.1)
  credit.py        zero-sum credit system (§2.5.2)
  matching.py      real-time online bipartite matching (§2.5.3)
  lottery.py       optional lottery incentives (§2.5.4)
  verification.py  validation → selection → verification (§2.5.5, Eq. 6)
  simulator.py     event-driven network simulation of the whole system
  runtime.py       client-backed SellerRuntime: sellers fit server-prepared
                   corpora through the versioned Vedalia protocol

`repro_torch.offload` closes the loop with the serving stack: the stream
scheduler's full re-fits are leased through this marketplace to a
simulated device fleet, with `Marketplace.reverify` wired to a real
server-side re-Gibbs spot-check and the verified winner adopted into the
serving handle.

These modules are this package's own copies of the JAX package's
`chital` leaves, which import no jax: the marketplace logic is host code
and identical in both packages; only `runtime.py` speaks to a server, the
port's `VedaliaClient`.
"""
