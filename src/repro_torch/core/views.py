"""Model views (paper §4.2) — the bandwidth-frugal serving payload.

    "To reduce bandwidth and protect models from outside use, we avoid
     sending the entire model to the end user. The initial model view is
     streamed to the user as a list of topic descriptions (id, probability,
     expected rating, expected helpfulness, expected unhelpfulness) and their
     associated top n words."

Expected rating per topic comes from the rating-tier structure folded into
the augmented vocabulary (tier of augmented word id = id % 5 → stars 1..5);
expected helpfulness/unhelpfulness are count-weighted document averages.
"""

from __future__ import annotations

import base64
import dataclasses
import json
from typing import Optional

import numpy as np

from repro_torch.core import codec, quant
from repro_torch.core.rlda import NUM_TIERS, RLDACorpus, strip_rating
from repro_torch.core.types import LDAState

#: Version of the serialized `ModelView` format. Version 1 is the original
#: plain JSON topic list (still emitted for unquantized views, still
#: parsed); version 2 is the enveloped form `{"view_version", "quant",
#: "topics"}` whose topics may carry int8/int4 word weights.
VIEW_VERSION = 2


class ViewVersionError(ValueError):
    """A serialized view is from a newer format than this client speaks.

    The typed ``resync`` signal: callers catch this (instead of an opaque
    parse error) and re-open a full unquantized sync. `got` is the
    offending wire version; `resync` is always True.
    """

    def __init__(self, got, speaks: int = VIEW_VERSION):
        super().__init__(
            f"view_version {got!r} is newer than this client's "
            f"{speaks}; full resync required")
        self.got = got
        self.speaks = speaks
        self.resync = True


@dataclasses.dataclass
class TopicView:
    topic_id: int
    probability: float
    expected_rating: float
    expected_helpful: float
    expected_unhelpful: float
    top_words: list[int]  # base-vocab ids, rating suffix stripped
    top_word_weights: list[float]

    def to_dict(self):
        return dataclasses.asdict(self)


def encode_topic_q(t: TopicView, bits: int) -> dict:
    """Compact quantized topic dict: single-letter keys, scalars rounded
    to display precision, word weights as base64 codes + one scale."""
    w = np.asarray(t.top_word_weights, np.float32)
    codes, scales = quant.quantize_rows(w[None, :], bits)
    return {
        "t": int(t.topic_id),
        "p": round(float(t.probability), 6),
        "r": round(float(t.expected_rating), 4),
        "h": round(float(t.expected_helpful), 4),
        "u": round(float(t.expected_unhelpful), 4),
        "w": [int(x) for x in t.top_words],
        "q": base64.b64encode(codes.tobytes()).decode("ascii"),
        "s": float(scales[0]),
    }


def decode_topic_q(d: dict, bits: int) -> TopicView:
    k = len(d["w"])
    codes = np.frombuffer(base64.b64decode(d["q"]), np.uint8)[None, :]
    weights = quant.dequantize_rows(
        codes, np.asarray([d["s"]], np.float32), bits, k)[0]
    return TopicView(
        topic_id=int(d["t"]),
        probability=float(d["p"]),
        expected_rating=float(d["r"]),
        expected_helpful=float(d["h"]),
        expected_unhelpful=float(d["u"]),
        top_words=[int(x) for x in d["w"]],
        top_word_weights=[float(x) for x in weights],
    )


@dataclasses.dataclass
class ModelView:
    topics: list[TopicView]

    def to_json(self, quant_spec=None) -> str:
        """Serialize for the wire.

        Default: the version-1 plain topic list (byte-identical to the
        pre-`view_version` format, so existing payload contracts hold).
        With a packed `QuantSpec`, the version-2 envelope whose topics
        carry base64 int8/int4 word-weight codes + one scale each —
        roughly 2.5x smaller per topic.
        """
        if quant_spec is None or not quant_spec.packed:
            return json.dumps([t.to_dict() for t in self.topics])
        return json.dumps({
            "view_version": VIEW_VERSION,
            "quant": quant_spec.to_wire(),
            "topics": [encode_topic_q(t, quant_spec.bits)
                       for t in self.topics],
        })

    @staticmethod
    def from_json(s: str) -> "ModelView":
        """Parse either serialized form.

        Raises :class:`ViewVersionError` (not a shape/parse error) when
        the payload announces a `view_version` newer than this build —
        the caller's cue to resync unquantized.
        """
        obj = json.loads(s)
        if isinstance(obj, list):  # version-1 plain list
            return ModelView(topics=[TopicView(**d) for d in obj])
        if not isinstance(obj, dict):
            raise ValueError("serialized view must be a list or object")
        ver = obj.get("view_version")
        if ver not in (1, VIEW_VERSION):
            raise ViewVersionError(ver)
        mode = obj.get("quant")
        topics = obj.get("topics", [])
        if mode is None:
            return ModelView(topics=[TopicView(**d) for d in topics])
        spec = quant.QuantSpec.from_wire(mode)
        return ModelView(
            topics=[decode_topic_q(d, spec.bits) for d in topics])

    def validate(self) -> bool:
        """Chital validation stage (§2.5.5): basic distribution sanity.

        Non-finite values are rejected explicitly: NaN compares False
        against everything, so ``probability=nan`` would sail through both
        the negativity and the sum checks (and ``nan <= rating`` likewise).
        """
        if not self.topics:
            return False
        probs = np.array([t.probability for t in self.topics])
        if not np.isfinite(probs).all():
            return False
        if (probs < 0).any() or probs.sum() > 1.0 + 1e-6:
            return False
        for t in self.topics:
            w = np.array(t.top_word_weights)
            if not np.isfinite(w).all():
                return False
            if (w < 0).any() or w.sum() > 1.0 + 1e-6:
                return False
            scalars = np.array([t.expected_rating, t.expected_helpful,
                                t.expected_unhelpful])
            if not np.isfinite(scalars).all():
                return False
            if not (1.0 <= t.expected_rating <= 5.0):
                return False
        return True


# -- delta views (§4.2 bandwidth) --------------------------------------------

# A topic is re-sent when its mass moved by more than REL_MASS_TOL
# (relative), its top-word list changed, or any surviving top-word weight
# moved by more than WEIGHT_TOL (absolute). Expected rating/helpfulness ride
# along whenever the topic is re-sent; they never trigger a resend alone.
REL_MASS_TOL = 0.05
WEIGHT_TOL = 0.02


def topic_signature(t: TopicView) -> dict:
    """The compact per-topic summary a view cursor stores for later diffs."""
    return {
        "probability": t.probability,
        "top_words": list(t.top_words),
        "top_word_weights": list(t.top_word_weights),
    }


def topic_changed(
    sig: Optional[dict],
    t: TopicView,
    *,
    rel_mass_tol: float = REL_MASS_TOL,
    weight_tol: float = WEIGHT_TOL,
) -> bool:
    """Has this topic drifted beyond the delta thresholds since `sig`?

    `sig=None` (topic not in the client's last sync) always counts as
    changed — new core-set topics must be transmitted in full.
    """
    if sig is None:
        return True
    old_p = sig["probability"]
    denom = max(abs(old_p), 1e-12)
    if abs(t.probability - old_p) / denom > rel_mass_tol:
        return True
    if list(t.top_words) != list(sig["top_words"]):
        return True
    old_w = np.asarray(sig["top_word_weights"], np.float64)
    new_w = np.asarray(t.top_word_weights, np.float64)
    if old_w.shape != new_w.shape:
        return True
    return bool(len(new_w) and np.abs(new_w - old_w).max() > weight_tol)


def signature_distance(sig: Optional[dict], t: TopicView) -> float:
    """Continuous drift in [0, 1] between a stored signature and a topic.

    `topic_changed` answers "must this topic be re-sent?" — a binary that
    trips on any top-word reorder, which is the right sensitivity for
    device sync but useless as a *refit* trigger (every micro-batch
    reorders something). This is the graded counterpart the streaming
    scheduler thresholds instead: the mean of

      * relative topic-mass shift (capped at 1),
      * Jaccard distance of the top-word sets,
      * L1 distance of the weights of surviving top words (capped at 1).

    `sig=None` (topic newly in the core set) is maximal drift (1.0).
    """
    if sig is None:
        return 1.0
    old_p = float(sig["probability"])
    mass = min(abs(t.probability - old_p) / max(abs(old_p), 1e-12), 1.0)
    old_set, new_set = set(sig["top_words"]), set(t.top_words)
    union = old_set | new_set
    jaccard = 1.0 - (len(old_set & new_set) / len(union)) if union else 0.0
    shared = old_set & new_set
    if shared:
        old_w = dict(zip(sig["top_words"], sig["top_word_weights"]))
        new_w = dict(zip(t.top_words, t.top_word_weights))
        l1 = min(sum(abs(new_w[w] - old_w[w]) for w in shared), 1.0)
    else:
        l1 = 1.0
    return (mass + jaccard + l1) / 3.0


def view_drift(signatures: dict[int, dict], view: ModelView) -> float:
    """Mean signature distance of a view against the last-stored
    signatures; topics that left the core set count as maximal drift."""
    if not view.topics and not signatures:
        return 0.0
    current = {t.topic_id for t in view.topics}
    removed = [tid for tid in signatures if tid not in current]
    total = sum(signature_distance(signatures.get(t.topic_id), t)
                for t in view.topics) + float(len(removed))
    return total / max(len(view.topics) + len(removed), 1)


def diff_view(
    signatures: dict[int, dict],
    view: ModelView,
    *,
    rel_mass_tol: float = REL_MASS_TOL,
    weight_tol: float = WEIGHT_TOL,
) -> tuple[list[TopicView], list[int]]:
    """(changed topics to transmit, topic ids to drop client-side).

    `signatures` is the client's last-synced state: topic id ->
    :func:`topic_signature` dict.
    """
    changed = [
        t for t in view.topics
        if topic_changed(signatures.get(t.topic_id), t,
                         rel_mass_tol=rel_mass_tol, weight_tol=weight_tol)
    ]
    current = {t.topic_id for t in view.topics}
    removed = sorted(tid for tid in signatures if tid not in current)
    return changed, removed


def build_view(
    prep: RLDACorpus,
    state: LDAState,
    topic_ids: list[int],
    top_n: int = 10,
) -> ModelView:
    """Compute the streamed model view for a set of (core) topics."""
    cfg = prep.cfg
    n_dt, n_wt, _ = codec.codec_for(cfg).decode_counts_np(state)
    n_t = n_wt.sum(axis=0)
    total = max(n_t.sum(), 1e-9)

    # The augmented-id -> (base word, tier) map is invariant across topics.
    base, tier = strip_rating(np.arange(cfg.vocab_size))

    views = []
    for t in topic_ids:
        # Aggregate augmented-word counts back to base words for display.
        col = n_wt[:, t]
        base_counts = np.bincount(base, weights=col, minlength=prep.base_vocab)
        top = np.argsort(-base_counts)[:top_n]
        denom = max(base_counts.sum(), 1e-9)

        # Expected rating: tier mass within the topic (tiers are 1..5 stars).
        tier_mass = np.bincount(tier, weights=col, minlength=NUM_TIERS)
        tw = tier_mass / max(tier_mass.sum(), 1e-9)
        exp_rating = float(np.dot(tw, np.arange(1, NUM_TIERS + 1)))

        # Expected helpful/unhelpful: doc-count-weighted averages.
        doc_w = n_dt[:, t]
        dw = doc_w / max(doc_w.sum(), 1e-9)
        exp_help = float(np.dot(dw, prep.helpful))
        exp_unhelp = float(np.dot(dw, prep.unhelpful))

        views.append(
            TopicView(
                topic_id=int(t),
                probability=float(n_t[t] / total),
                expected_rating=min(max(exp_rating, 1.0), 5.0),
                expected_helpful=exp_help,
                expected_unhelpful=exp_unhelp,
                top_words=[int(w) for w in top],
                top_word_weights=[float(base_counts[w] / denom) for w in top],
            )
        )
    return ModelView(topics=views)


def top_reviews_for_topic(
    prep: RLDACorpus, state: LDAState, topic_id: int, n: int = 5
) -> list[int]:
    """Topic-probability-sorted review ids (the ViewPager ordering, §3.4)."""
    n_dt = codec.codec_for(prep.cfg).decode_array_np(state.n_dt)
    theta = (n_dt + prep.cfg.alpha) / (
        n_dt.sum(1, keepdims=True) + prep.cfg.alpha * prep.cfg.num_topics
    )
    return [int(d) for d in np.argsort(-theta[:, topic_id])[:n]]
