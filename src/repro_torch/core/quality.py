"""Review-quality logistic model: {ν_d, u_d, h_d} -> is_relevant (paper §4.3).

ψ_d = P(is_relevant) is the review's fractional count weight. Everything is
computed in float32, as the reference computes it (JAX without x64).
Training is full-batch gradient descent (a hand-label-scale dataset).
"""

from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass(frozen=True)
class QualityModel:
    w: torch.Tensor  # (3,) weights for (ν, u, h) — standardized features
    b: torch.Tensor  # scalar bias
    mean: torch.Tensor  # (3,) feature standardization
    std: torch.Tensor  # (3,)


def _f32(x) -> torch.Tensor:
    return torch.as_tensor(x).to(torch.float32)


def _features(nu, u, h) -> torch.Tensor:
    # log1p vote counts — raw vote counts are heavy-tailed.
    return torch.stack([_f32(nu), torch.log1p(_f32(u)), torch.log1p(_f32(h))], dim=-1)


def default_model() -> QualityModel:
    """Prior model when no labels are available: quality rises with
    writing quality and helpful votes, falls with unhelpful votes."""
    return QualityModel(
        w=torch.tensor([1.5, -1.0, 1.0]),
        b=torch.tensor(1.0),
        mean=torch.zeros(3),
        std=torch.ones(3),
    )


def predict(model: QualityModel, nu, u, h) -> torch.Tensor:
    x = (_features(nu, u, h) - model.mean) / model.std
    return torch.sigmoid(x @ model.w + model.b)


def train(nu, u, h, labels, *, steps: int = 500, lr: float = 0.3,
          l2: float = 1e-3) -> QualityModel:
    """Full-batch logistic regression on hand-labeled relevance."""
    x_raw = _features(nu, u, h)
    mean = x_raw.mean(0)
    std = torch.clamp(x_raw.std(0, correction=0), min=1e-6)
    x = (x_raw - mean) / std
    y = _f32(labels)
    w = torch.zeros(3)
    b = torch.tensor(0.0)
    n = x.shape[0]
    for _ in range(steps):
        # d/dlogit of the stable log-loss max(l,0) - l*y + log1p(exp(-|l|)):
        # sigmoid(l) - y, except at l == 0, where the reference's autodiff
        # takes the subgradient -y (it matters on the first step from 0).
        logits = x @ w + b
        r = ((logits > 0).to(torch.float32) - y
             - torch.sign(logits) * torch.sigmoid(-logits.abs()))
        gw = x.T @ r / n + 2.0 * l2 * w
        gb = r.mean()
        w, b = w - lr * gw, b - lr * gb
    return QualityModel(w=w, b=b, mean=mean, std=std)


def accuracy(model: QualityModel, nu, u, h, labels) -> float:
    p = predict(model, nu, u, h)
    return float(((p > 0.5) == (_f32(labels) > 0.5)).float().mean())
