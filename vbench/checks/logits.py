"""Check `logits`: a served model's greedy tokens and logits, and its Mamba2
layers, against the plain reference (`vbench.reference.hybrid`).

The tap wraps the program's model entries that the serving engine calls
through their modules: `repro_torch.models.model.prefill` and
`decode_step`, and `repro_torch.models.ssm.mamba2_mix`, each Mamba2
layer's mixer in a prefill. For the armed requests (the window's first
ARMED; a request serves a wave at each prompt length of its mix) it keeps
references, and copies nothing: each wave's prompt tokens and the last
position's logits that prefill returned, and each decode step's input
tokens, position and logits. In the armed wave with the longest prompt it
also keeps, for LAYERS Mamba2 layers (the first, and others drawn from
the run's seed), the mixer's normed input, its output and its last scan
state.

After the window the check takes CHECKED of the armed waves: the one with
the longest prompt, and others drawn from the run's seed. For each it
runs the reference once, in float32, over the prompts with the tokens
served (teacher-forced), and compares at each served position (the
prompt's last, and each decode step's):

  logit_dev      the largest, over the positions, of max |program -
                 reference| over the reference row's standard deviation
  token_gap      the widest gap, in the same units, by which a served
                 token's reference logit lies below the reference's best
  not_argmax     served or fed tokens that are not the argmax of the
                 program's own logits before them
  steps_missing  prefills other than one, decode steps other than
                 max_new - 1, a wave
  inputs_altered prompt rows that reached prefill other than sent, and
                 decode steps at a position other than the prompt's
                 length plus the step
  unchecked      checked waves with no prefill record (1 where no armed
                 wave finished), and 1 where no Mamba2 layer was kept

The logits follow the whole forward from the prompt; the kept layers are
checked on their own, the reference's mixer run on the program's input to
that layer (its normed hidden state), so that a lower precision inside
the scan is not lost in the drift of 54 bfloat16 layers:

  mixer_dev      the largest, over the kept layers, of |program output -
                 reference output| / |reference output| (whole tensors)
  state_dev      the same of the last scan state

Each control (`CONTROLS`) is the reference a step down in one precision
that the configuration states, put in the program's place: `fp8_gemms`
rounds the inputs of every weight's product to float8 e4m3 (the
configuration's bfloat16 weights and activations), `bf16_states` holds
the Mamba2 states in bfloat16 token by token (the configuration's
float32 states). Its logits give `logit_dev`, its argmax at each position
`token_gap`, and its mixer on the same inputs `mixer_dev` and
`state_dev`.
"""

import dataclasses
import importlib
from typing import Any, Optional

import torch

from vbench.reference import hybrid as ref

MODEL = "repro_torch.models.model"
SSM = "repro_torch.models.ssm"
#: Requests armed: the window's first.
ARMED = 1
#: Waves checked after the window, and Mamba2 layers kept.
CHECKED = 4
LAYERS = 4
CONTROLS = {"fp8_gemms": {"matmul_dtype": torch.float8_e4m3fn},
            "bf16_states": {"state_dtype": torch.bfloat16}}
#: The numbers held to the cell's limits; the others (EXACT) take 0.
LIMITS = frozenset({"logit_dev", "token_gap", "mixer_dev", "state_dev"})
EXACT = ("not_argmax", "steps_missing", "inputs_altered", "unchecked")


@dataclasses.dataclass
class Record:
    kind: str  # "prefill" | "decode"
    request: int
    tokens: Any  # prefill: the prompts (B, L); decode: the fed tokens (B,)
    pos: Optional[int]  # decode: the position it was given
    logits: Any  # (B, V) float32


@dataclasses.dataclass
class Mixer:
    layer: int  # the Mamba2 layer, in the order prefill runs them
    h: Any  # its normed input (B, L, D)
    y: Any  # its output (B, L, D)
    state: Any  # its last scan state (B, H, N, P)


class Tap:
    """Wraps `prefill`, `decode_step` and `mamba2_mix` while installed;
    records while armed."""

    def __init__(self, rng):
        self.rng = rng
        self.armed = set(range(ARMED))
        self.records: list[Record] = []
        self.mixers: list[Mixer] = []  # of the longest armed prefill so far
        self.request: Optional[int] = None
        self.sample: Optional[list] = None  # the checked waves, drawn once
        self._layers: Optional[set] = None  # drawn at the first armed prefill
        self._longest = 0
        self._call: Optional[int] = None  # the Mamba2 layer next, while kept
        self._saved: list = []

    def install(self) -> "Tap":
        mod, ssm = importlib.import_module(MODEL), importlib.import_module(SSM)
        prefill, decode_step, mix = mod.prefill, mod.decode_step, ssm.mamba2_mix

        def tapped_prefill(params, cfg, batch, cache_len, **kwargs):
            plen = batch["tokens"].shape[1]
            if self.request is not None and plen > self._longest:
                if self._layers is None:
                    self._layers = {0, *self.rng.sample(range(1, cfg.num_layers),
                                                        min(LAYERS, cfg.num_layers) - 1)}
                self.mixers, self._longest, self._call = [], plen, 0
            try:
                out = prefill(params, cfg, batch, cache_len, **kwargs)
            finally:
                self._call = None
            if self.request is not None:
                self.records.append(Record("prefill", self.request, batch["tokens"], None,
                                           out[1]))
            return out

        def tapped_decode_step(params, cfg, cache, tokens, pos):
            out = decode_step(params, cfg, cache, tokens, pos)
            if self.request is not None:
                self.records.append(Record("decode", self.request, tokens, pos, out[1]))
            return out

        def tapped_mix(p, x, state, conv_state, cfg, **kwargs):
            y, (s, conv) = mix(p, x, state, conv_state, cfg, **kwargs)
            if self._call is not None:
                if self._call in self._layers:
                    self.mixers.append(Mixer(self._call, x, y, s))
                self._call += 1
            return y, (s, conv)

        self._saved = [(mod, "prefill", prefill), (mod, "decode_step", decode_step),
                       (ssm, "mamba2_mix", mix)]
        mod.prefill, mod.decode_step, ssm.mamba2_mix = (tapped_prefill, tapped_decode_step,
                                                        tapped_mix)
        return self

    def uninstall(self) -> None:
        for mod, attr, orig in self._saved:
            setattr(mod, attr, orig)
        self._saved = []


def _sample(tap: Tap, done: dict) -> list:
    """The longest finished wave and CHECKED - 1 others drawn with the
    tap's generator, once a run."""
    if tap.sample is None:
        by_len = sorted(done, key=lambda i: (-done[i]["prompts"].shape[1], i))
        rest = sorted(by_len[1:])
        tap.sample = by_len[:1] + sorted(tap.rng.sample(rest, min(CHECKED - 1, len(rest))))
    return tap.sample


def _waves(records: list, request: int) -> list:
    """A request's records, a list a wave: each starts at its prefill."""
    waves: list = []
    for r in records:
        if r.request == request:
            if r.kind == "prefill" or not waves:
                waves.append([])
            waves[-1].append(r)
    return waves


def _rel(x, ref_rows):
    """(x - ref) over each reference row's standard deviation."""
    return (x - ref_rows) / ref_rows.std(dim=-1, keepdim=True)


def _gap(ref_rows, tokens):
    """How far each chosen token's reference logit lies below the row's
    best, over the row's standard deviation."""
    best = ref_rows.max(dim=-1).values
    chosen = ref_rows.gather(-1, tokens[..., None].long())[..., 0]
    return (best - chosen) / ref_rows.std(dim=-1)


def _wave(cell, lm, recs, kept, control, out: dict) -> None:
    new = cell.mix["request"]["max_new"]
    pre = [r for r in recs if r.kind == "prefill"]
    dec = [r for r in recs if r.kind == "decode"]
    out["steps_missing"] += abs(len(pre) - 1) + abs(len(dec) - (new - 1))
    if not pre:
        out["unchecked"] += 1
        return
    dev = pre[0].logits.device
    prompts = torch.as_tensor(kept["prompts"], device=dev)
    served = torch.as_tensor(kept["tokens"], device=dev).long()  # (B, new)
    plen = prompts.shape[1]
    sent = pre[0].tokens.to(dev)
    out["inputs_altered"] += (int((sent != prompts).any(-1).sum()) if sent.shape == prompts.shape
                              else prompts.shape[0])
    out["inputs_altered"] += sum(r.pos != plen + j for j, r in enumerate(dec))
    logits = [pre[0].logits] + [r.logits for r in dec]  # each (B, V), before token j
    for j, lg in enumerate(logits[:new]):
        best = lg.argmax(-1)
        if j < served.shape[1]:
            out["not_argmax"] += int((served[:, j] != best).sum())
        if j < len(dec):
            out["not_argmax"] += int((dec[j].tokens.to(dev).long() != best).sum())
    positions = min(len(logits), served.shape[1])
    tokens = torch.cat([prompts.long(), served[:, :positions - 1]], dim=1)
    want = ref.logits(lm.params, cell.config, tokens, positions)  # (B, positions, V)
    if control:
        got = ref.logits(lm.params, cell.config, tokens, positions, **CONTROLS[control])
        chosen = got.argmax(-1)
    else:
        got = torch.stack([lg.float() for lg in logits[:positions]], dim=1)
        chosen = served[:, :positions]
    out["logit_dev"] = max(out["logit_dev"], float(_rel(got, want).abs().max()))
    out["token_gap"] = max(out["token_gap"], float(_gap(want, chosen).max()))


def _norm_dev(got, want) -> float:
    """|got - want| / |want| over whole tensors, in float32."""
    got, want = got.float(), want.float()
    if got.shape != want.shape:
        raise ValueError(f"shape {tuple(got.shape)}, the reference's {tuple(want.shape)}")
    return float(torch.linalg.vector_norm(got - want) / torch.linalg.vector_norm(want))


def _mixers(cell, lm, tap: Tap, control, out: dict) -> None:
    """The kept Mamba2 layers, each from the program's input to it."""
    if not tap.mixers:
        out["unchecked"] += 1
    per = cell.config["hybrid_attn_every"]
    for m in tap.mixers:
        p = ref.layer(lm.params["blk"], *divmod(m.layer, per))
        with ref.exact_float32(), torch.no_grad():
            want_y, want_s = ref.mixer(p, m.h, cell.config)
            got_y, got_s = (ref.mixer(p, m.h, cell.config, **CONTROLS[control]) if control
                            else (m.y, m.state))
        out["mixer_dev"] = max(out["mixer_dev"], _norm_dev(got_y, want_y))
        out["state_dev"] = max(out["state_dev"], _norm_dev(got_s, want_s))


def _blank() -> dict:
    return dict.fromkeys(("logit_dev", "token_gap", "mixer_dev", "state_dev") + EXACT, 0.0)


def check(cell, inputs, tap: Tap, products: dict, control=None) -> dict:
    """The numbers of the checked waves among the armed requests' finished
    ones (`products`: request -> each wave's prompts and tokens), and of
    the kept Mamba2 layers; with `control`, one of CONTROLS, the
    control's."""
    done = {(i, j): wave for i, kept in products.items() if kept for j, wave in enumerate(kept)}
    out = _blank()
    if not done:  # no armed request finished
        out["unchecked"] = 1.0
    for i, j in _sample(tap, done):
        waves = _waves(tap.records, i)
        _wave(cell, inputs, waves[j] if j < len(waves) else [], done[i, j], control, out)
    _mixers(cell, inputs, tap, control, out)
    if control:
        for name in EXACT:  # the control serves no tokens of its own
            out[name] = 0.0
    return out


def verdict(numbers: dict, limits: dict) -> tuple[bool, dict]:
    """(every number within its limit, {name: {"value", "limit"}}); the
    exact counts take the limit 0."""
    table = {name: {"value": value, "limit": 0.0 if name in EXACT else limits[name]}
             for name, value in numbers.items()}
    return all(row["value"] <= row["limit"] for row in table.values()), table


def unread(products: dict) -> dict:
    out = _blank()
    waves = sum(len(kept) for kept in products.values() if kept)
    out["unchecked"] = float(min(CHECKED, waves) + 1)
    return out


def context(tap: Tap) -> dict:  # noqa: ARG001
    return {}
