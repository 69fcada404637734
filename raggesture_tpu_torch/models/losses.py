"""Loss functions with weighted reduction.  Port of
``raggesture_tpu/models/losses.py``.

``mse_loss`` and ``laplacian_mse_loss`` are element-wise;
``weight_reduce_loss`` applies an optional element weight, then reduces by
mean, sum or none with an optional averaging factor (the mmcv
``weighted_loss`` contract).  ``LaplacianMSELoss`` is the kornia
``laplacian_1d``-filtered variant (registered in the reference, unused by
the shipped config).
"""

from __future__ import annotations

from typing import Optional

import torch


def reduce_loss(loss: torch.Tensor, reduction: str) -> torch.Tensor:
    if reduction == "none":
        return loss
    if reduction == "mean":
        return loss.mean()
    if reduction == "sum":
        return loss.sum()
    raise ValueError(f"unknown reduction {reduction!r}")


def weight_reduce_loss(loss: torch.Tensor,
                       weight: Optional[torch.Tensor] = None,
                       reduction: str = "mean",
                       avg_factor: Optional[float] = None) -> torch.Tensor:
    """The element weight, then the reduction; with ``avg_factor`` the
    mean is the sum over ``avg_factor``."""
    if weight is not None:
        loss = loss * weight
    if avg_factor is None:
        return reduce_loss(loss, reduction)
    if reduction == "mean":
        return loss.sum() / avg_factor
    if reduction == "none":
        return loss
    raise ValueError("avg_factor only supported with mean reduction")


def mse_loss(pred: torch.Tensor, target: torch.Tensor,
             weight: Optional[torch.Tensor] = None, reduction: str = "mean",
             avg_factor: Optional[float] = None) -> torch.Tensor:
    return weight_reduce_loss((pred - target) ** 2, weight, reduction,
                              avg_factor)


def laplacian_1d(window_size: int = 3) -> torch.Tensor:
    """kornia's ``laplacian_1d``: ones with the centre 1 - window_size
    (summing to zero)."""
    k = torch.ones(window_size)
    k[window_size // 2] = 1.0 - window_size
    return k


def laplacian_filter_time(x: torch.Tensor,
                          window_size: int = 3) -> torch.Tensor:
    """The 1-d laplacian along the time axis of (B, T, D), the ends padded
    by replication (kornia's ``filter1d``)."""
    k = laplacian_1d(window_size).to(x)
    pad = window_size // 2
    xp = torch.cat([x[:, :1].expand(-1, pad, -1), x,
                    x[:, -1:].expand(-1, pad, -1)], dim=1)
    T = x.shape[1]
    return sum(k[i] * xp[:, i:i + T] for i in range(window_size))


def laplacian_mse_loss(pred: torch.Tensor, target: torch.Tensor,
                       weight: Optional[torch.Tensor] = None,
                       reduction: str = "mean",
                       avg_factor: Optional[float] = None) -> torch.Tensor:
    """The MSE between the laplacian-filtered sequences."""
    lp = laplacian_filter_time(pred)
    lt = laplacian_filter_time(target)
    return weight_reduce_loss((lp - lt) ** 2, weight, reduction, avg_factor)


class MSELoss:
    """A configured weighted MSE."""

    def __init__(self, reduction: str = "mean", loss_weight: float = 1.0):
        if reduction not in ("none", "mean", "sum"):
            raise ValueError(f"unknown reduction {reduction!r}")
        self.reduction = reduction
        self.loss_weight = loss_weight

    def __call__(self, pred, target, weight=None, avg_factor=None,
                 reduction_override=None):
        reduction = reduction_override or self.reduction
        return self.loss_weight * mse_loss(pred, target, weight, reduction,
                                           avg_factor)


class LaplacianMSELoss(MSELoss):
    """A configured weighted MSE of the laplacian-filtered sequences."""

    def __call__(self, pred, target, weight=None, avg_factor=None,
                 reduction_override=None):
        reduction = reduction_override or self.reduction
        return self.loss_weight * laplacian_mse_loss(
            pred, target, weight, reduction, avg_factor)
