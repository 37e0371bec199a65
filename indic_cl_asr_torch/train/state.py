"""AdamW over the trainable parameters, with the encoder's frozen prefix.

Port of indic_cl_asr_tpu/train/state.py: ``optax.adamw`` (β 0.9/0.999,
eps 1e-8, decoupled weight decay) after an optional
``optax.clip_by_global_norm``, over the trainable parameters only. With
``freeze_encoder_till = F > 0``, ``pre_encode`` and encoder layers [0, F)
are frozen, as ``conformer_freeze_mask`` and ``row_sliced_stacked`` freeze
them: they hold no optimizer state and are never read or written by an
update, weight decay included.

The arithmetic is optax's, in its order, in f32:

    mu = (1-b1)·g + b1·mu;   nu = (1-b2)·g² + b2·nu
    u  = (mu / (1-b1^t)) / (sqrt(nu / (1-b2^t)) + eps)
    p  = p + (-lr)·(u + wd·p)

so an update agrees with the JAX package's to f32 rounding. The global-norm
clip scales by ``max_norm / ‖g‖`` where ‖g‖ >= max_norm, with no ``+1e-6``
in the divisor (unlike ``torch.nn.utils.clip_grad_norm_``).
"""

from __future__ import annotations

import torch

from ..device import resolve_device

B1, B2, EPS = 0.9, 0.999, 1e-8  # optax.adamw as make_optimizer sets it


def trainable_names(model, freeze_encoder_till: int) -> list[str]:
    """Names of the parameters the optimizer updates (the JAX package's
    ``conformer_freeze_mask``): all but pre_encode and encoder layers
    [0, freeze_encoder_till) when that is > 0."""
    F = max(int(freeze_encoder_till), 0)

    def frozen(name: str) -> bool:
        if F <= 0:
            return False
        if name.startswith("encoder.pre_encode."):
            return True
        if name.startswith("encoder.layers."):
            return int(name.split(".")[2]) < F
        return False

    return [n for n, _ in model.named_parameters() if not frozen(n)]


class AdamW:
    """optax.adamw (+ clip_by_global_norm) over a fixed list of parameters.

    ``step(grads)`` applies one update from gradients given in the order of
    ``self.params`` (None = no gradient this step, treated as zero, as a
    parameter outside the loss's graph has in the JAX package)."""

    def __init__(self, named_params: list[tuple[str, torch.nn.Parameter]],
                 lr: float = 1e-4, weight_decay: float = 0.01,
                 grad_clip: float | None = None):
        self.names = [n for n, _ in named_params]
        self.params = [p for _, p in named_params]
        for p in self.params:
            if p.dtype != torch.float32:
                raise TypeError("AdamW keeps f32 master parameters")
        self.lr, self.weight_decay = lr, weight_decay
        self.grad_clip = grad_clip
        self.count = 0
        self.mu = [torch.zeros_like(p) for p in self.params]
        self.nu = [torch.zeros_like(p) for p in self.params]

    @torch.no_grad()
    def step(self, grads) -> None:
        g = [torch.zeros_like(p) if x is None else x.to(torch.float32)
             for p, x in zip(self.params, grads)]
        if self.grad_clip:
            norm = torch.sqrt(sum(torch.sum(x * x) for x in g))
            # optax: where(norm < max_norm, g, (g / norm) * max_norm)
            g = [torch.where(norm < self.grad_clip, x, (x / norm) * self.grad_clip)
                 for x in g]
        self.count += 1
        torch._foreach_mul_(self.mu, B1)
        torch._foreach_add_(self.mu, torch._foreach_mul(g, 1.0 - B1))
        torch._foreach_mul_(self.nu, B2)
        torch._foreach_add_(self.nu, torch._foreach_mul(torch._foreach_mul(g, g), 1.0 - B2))
        # bias corrections in f32, as optax computes decay**count
        t = torch.tensor(self.count, dtype=torch.float32)
        bc1 = float(1.0 - torch.tensor(B1, dtype=torch.float32) ** t)
        bc2 = float(1.0 - torch.tensor(B2, dtype=torch.float32) ** t)
        mu_hat = torch._foreach_div(self.mu, bc1)
        nu_hat = torch._foreach_div(self.nu, bc2)
        denom = torch._foreach_add(torch._foreach_sqrt(nu_hat), EPS)
        u = torch._foreach_div(mu_hat, denom)
        if self.weight_decay:
            torch._foreach_add_(u, torch._foreach_mul(self.params, self.weight_decay))
        torch._foreach_mul_(u, -self.lr)
        torch._foreach_add_(self.params, u)


def make_optimizer(model, lr: float = 1e-4, weight_decay: float = 0.01,
                   freeze_encoder_till: int = 0, grad_clip: float | None = None,
                   device=None) -> AdamW:
    """AdamW over ``model``'s trainable parameters, which this marks
    ``requires_grad`` (and the frozen ones not). ``device`` defaults to the
    CUDA card and must be the model's (``"cpu"`` for the plain path)."""
    dev = resolve_device(device)
    if model.device.type != dev.type:
        raise ValueError(f"model is on {model.device}, optimizer asked for {dev}")
    keep = set(trainable_names(model, freeze_encoder_till))
    for name, p in model.named_parameters():
        p.requires_grad_(name in keep)
    named = [(n, p) for n, p in model.named_parameters() if n in keep]
    return AdamW(named, lr=lr, weight_decay=weight_decay, grad_clip=grad_clip)
