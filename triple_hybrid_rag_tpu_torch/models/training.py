"""Contrastive training for the query encoder: symmetric InfoNCE over (query,
positive-passage) pairs, on one device.

A port of the JAX package's ``models/training.py``. The loss is the reference's,
term for term: InfoNCE over in-batch negatives at each Matryoshka prefix width of
the pooled embedding, plus a token-level MaxSim InfoNCE term (ColBERT's objective)
that trains the late-interaction head, both over the embeddings blended with the
identity anchors as serving blends them. The reference differentiates it with
``jax.value_and_grad`` through XLA, and no Pallas kernel is on the way (the MaxSim
term is an ``einsum``); here ``torch.autograd`` differentiates the same plain ops.

The optimizer is optax's ``adamw`` over ``warmup_cosine_decay_schedule``, written
out in PyTorch (:class:`AdamW`, :func:`warmup_cosine_decay_schedule`,
:func:`cosine_decay_schedule`): decay on every parameter, the learning rate read
at the count before the increment (step 0 runs at lr 0 and leaves the parameters
unchanged).

The reference also shards the step over a dp x tp mesh (``training_mesh``,
``param_shardings``, ``shard_train_state``); a ``mesh`` argument here raises
(ROADMAP.md, Queue 1: multi-GPU).
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Callable, Dict, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ..device import resolve_device
from .encoder import Encoder, EncoderConfig, _anchor_weights, _const, init_encoder


@dataclass(frozen=True)
class TrainConfig:
    learning_rate: float = 3e-4
    weight_decay: float = 0.01
    temperature: float = 0.05
    warmup_steps: int = 100
    decay_steps: int = 10_000  # cosine horizon; set ~= total steps so runs end decayed
    # Matryoshka prefix training: InfoNCE is averaged over these pooled-embedding
    # prefix widths so truncated vectors stay retrieval-quality. () = full width only.
    matryoshka_dims: Tuple[int, ...] = ()
    # weight of the token-level MaxSim InfoNCE term (trains the late-interaction
    # head, ColBERT-style); 0 = pooled-only training.
    maxsim_weight: float = 0.0


def _no_mesh(mesh) -> None:
    if mesh is not None:
        raise NotImplementedError(
            "sharded training over a device mesh is not ported (ROADMAP.md, Queue 1: multi-GPU)"
        )


# ---------------------------------------------------------------------------
# schedules and AdamW, as optax computes them (f32 arithmetic)
# ---------------------------------------------------------------------------

_F32 = np.float32


def cosine_decay_schedule(init_value: float, decay_steps: int, alpha: float = 0.0,
                          exponent: float = 1.0) -> Callable[[int], float]:
    """optax's ``cosine_decay_schedule``: step -> learning rate, in f32."""
    if not decay_steps > 0:
        raise ValueError(f"cosine_decay_schedule requires positive decay_steps, got {decay_steps}")

    def schedule(count: int) -> float:
        c = np.minimum(_F32(count), _F32(decay_steps))
        # the cosine of the f32 angle, rounded once to f32 (XLA's f32 cosine
        # agrees with that to the last bit where numpy's f32 cosine does not)
        cosine = _F32(0.5) * (_F32(1) + _F32(math.cos(_F32(np.pi) * c / _F32(decay_steps))))
        decayed = _F32(1 - alpha) * cosine ** _F32(exponent) + _F32(alpha)
        return float(_F32(init_value) * decayed)

    return schedule


def warmup_cosine_decay_schedule(init_value: float, peak_value: float, warmup_steps: int,
                                 decay_steps: int, end_value: float = 0.0) -> Callable[[int], float]:
    """optax's ``warmup_cosine_decay_schedule``: linear from ``init_value`` to
    ``peak_value`` over ``warmup_steps``, then a cosine to ``end_value`` at
    ``decay_steps``."""
    alpha = 0.0 if peak_value == 0.0 else end_value / peak_value
    cosine = cosine_decay_schedule(peak_value, decay_steps - warmup_steps, alpha)

    def schedule(count: int) -> float:
        if count >= warmup_steps:
            return cosine(count - warmup_steps)
        if warmup_steps <= 0:
            return float(_F32(init_value))
        frac = _F32(1) - _F32(min(max(count, 0), warmup_steps)) / _F32(warmup_steps)
        return float(_F32(init_value - peak_value) * frac + _F32(peak_value))

    return schedule


@dataclass
class AdamWState:
    """The optimizer's moments per parameter name and its update count."""

    mu: Dict[str, torch.Tensor]
    nu: Dict[str, torch.Tensor]
    count: int = 0


@dataclass(frozen=True)
class AdamW:
    """optax's ``adamw(schedule, weight_decay)`` over f32 parameters: scale_by_adam
    (b1 0.9, b2 0.999, eps 1e-8), add the decayed weights (every parameter), scale
    by the negative learning rate of the count before the increment, add. Each
    term in optax's order, so the moments are bit-equal to optax's."""

    schedule: Callable[[int], float]
    weight_decay: float = 1e-4
    b1: float = 0.9
    b2: float = 0.999
    eps: float = 1e-8

    def init(self, params: Dict[str, torch.Tensor]) -> AdamWState:
        zeros = lambda: {k: torch.zeros_like(p) for k, p in params.items()}
        return AdamWState(mu=zeros(), nu=zeros(), count=0)

    @torch.no_grad()
    def update_(self, params: Dict[str, torch.Tensor], grads: Dict[str, torch.Tensor],
                state: AdamWState) -> None:
        """One step, in place on ``params`` and ``state``."""
        lr = self.schedule(state.count)
        state.count += 1
        bc1 = float(_F32(1) - _F32(self.b1) ** _F32(state.count))
        bc2 = float(_F32(1) - _F32(self.b2) ** _F32(state.count))
        names = list(params)
        ps = [params[k] for k in names]
        gs = [grads[k] for k in names]
        mus = [state.mu[k] for k in names]
        nus = [state.nu[k] for k in names]
        # mu = (1 - b1) g + b1 mu; nu = (1 - b2) g^2 + b2 nu
        g1 = torch._foreach_mul(gs, 1 - self.b1)
        torch._foreach_mul_(mus, self.b1)
        torch._foreach_add_(mus, g1)
        g2 = torch._foreach_mul(gs, gs)
        torch._foreach_mul_(g2, 1 - self.b2)
        torch._foreach_mul_(nus, self.b2)
        torch._foreach_add_(nus, g2)
        # the bias-corrected ratio, + wd * p, * -lr
        mh = torch._foreach_div(mus, bc1)
        nh = torch._foreach_div(nus, bc2)
        torch._foreach_sqrt_(nh)
        torch._foreach_add_(nh, self.eps)
        u = torch._foreach_div(mh, nh)
        torch._foreach_add_(u, torch._foreach_mul(ps, self.weight_decay))
        torch._foreach_mul_(u, -lr)
        torch._foreach_add_(ps, u)


# ---------------------------------------------------------------------------
# state and step
# ---------------------------------------------------------------------------


@dataclass
class TrainState:
    """The encoder being trained (its parameters are the state's), the
    optimizer's moments and count, and the optimizer."""

    model: Encoder
    opt_state: AdamWState
    tx: AdamW = field(repr=False)

    @property
    def step(self) -> int:
        return self.opt_state.count

    def params(self) -> Dict[str, torch.nn.Parameter]:
        return dict(self.model.named_parameters())


def create_train_state(
    enc_cfg: EncoderConfig,
    train_cfg: TrainConfig = TrainConfig(),
    seed: int = 0,
    mesh=None,
    device=None,
) -> Tuple[Encoder, TrainState]:
    """(model, state): a fresh :func:`~.encoder.init_encoder` model on ``device``
    (CUDA unless ``device="cpu"``) and AdamW over optax's warmup-cosine schedule."""
    _no_mesh(mesh)
    model = init_encoder(enc_cfg, seed, device=resolve_device(device))
    schedule = warmup_cosine_decay_schedule(
        0.0, train_cfg.learning_rate, train_cfg.warmup_steps, train_cfg.decay_steps
    )
    tx = AdamW(schedule, weight_decay=train_cfg.weight_decay)
    state = TrainState(model=model, opt_state=tx.init(dict(model.named_parameters())), tx=tx)
    return model, state


def info_nce(q: torch.Tensor, d: torch.Tensor, temp: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """(symmetric InfoNCE over in-batch negatives, logits [B, B])."""
    logits = (q @ d.T) / temp
    labels = torch.arange(logits.shape[0], device=logits.device)
    loss = 0.5 * (F.cross_entropy(logits, labels) + F.cross_entropy(logits.T, labels))
    return loss, logits


def training_blend(enc_cfg: EncoderConfig, pooled, tok, apool, atok):
    """The anchor blend inside the loss (not the serving blend): the token mix is
    normalized by rsqrt(sum of squares + 1e-12), so a padded all-zero row keeps a
    finite gradient; the pooled mix stays unnormalized (the Matryoshka loop
    truncates, then normalizes). An f16 anchor times its weight stays f16, as in
    JAX's weak typing; the sum with the f32 head is f32."""
    a_t, b_t, a_p, b_p = _anchor_weights(enc_cfg)
    if enc_cfg.anchor_token_w2 > 0:
        has = (atok != 0).any(dim=-1, keepdim=True)
        mix = _const(a_t, atok.dtype) * atok + b_t * tok
        mix = mix * torch.rsqrt((mix * mix).sum(dim=-1, keepdim=True) + 1e-12)
        tok = torch.where(has, mix, tok)
    if enc_cfg.anchor_pool_w2 > 0:
        has = (apool != 0).any(dim=-1, keepdim=True)
        pooled = torch.where(has, _const(a_p, apool.dtype) * apool + b_p * pooled, pooled)
    return pooled, tok


def contrastive_loss(model: Encoder, train_cfg: TrainConfig, q_ids, q_mask, q_apool, q_atok,
                     d_ids, d_mask, d_apool, d_atok) -> Tuple[torch.Tensor, torch.Tensor]:
    """(loss, accuracy at the full width) of one batch, differentiable."""
    temp = train_cfg.temperature
    q, q_tok = model(q_ids, q_mask)
    d, d_tok = model(d_ids, d_mask)
    q, q_tok = training_blend(model.cfg, q, q_tok, q_apool, q_atok)
    d, d_tok = training_blend(model.cfg, d, d_tok, d_apool, d_atok)
    dims = train_cfg.matryoshka_dims or (q.shape[-1],)
    loss = 0.0
    logits = None
    for dim in dims:
        qp, dp = q[:, :dim], d[:, :dim]
        qp = qp / torch.clamp(torch.linalg.vector_norm(qp, dim=-1, keepdim=True), min=1e-6)
        dp = dp / torch.clamp(torch.linalg.vector_norm(dp, dim=-1, keepdim=True), min=1e-6)
        part, lg = info_nce(qp, dp, temp)
        loss = loss + part / len(dims)
        if logits is None:  # accuracy reported at the full width
            logits = lg
    labels = torch.arange(logits.shape[0], device=logits.device)
    if train_cfg.maxsim_weight > 0:
        # token-level late interaction: score(i, j) = mean over i's query tokens of
        # their best match among ALL of j's doc positions (a padded doc token is a
        # zero vector and scores 0); only the query side is masked
        sim = torch.einsum("iqd,jtd->ijqt", q_tok, d_tok)  # [B, B, Tq, Td]
        best = sim.amax(dim=-1)  # ties share the gradient, as JAX's max does
        qm = q_mask.float()
        denom = torch.clamp(qm.sum(dim=1), min=1.0)
        ms = (best * qm[:, None, :]).sum(dim=-1) / denom[:, None]
        loss = loss + train_cfg.maxsim_weight * F.cross_entropy(ms / temp, labels)
    acc = (torch.argmax(logits, dim=1) == labels).float().mean()
    return loss, acc


def make_train_step(model: Encoder, train_cfg: TrainConfig, mesh=None):
    """The symmetric-InfoNCE step: ``step(state, q_ids, q_mask, q_apool, q_atok,
    d_ids, d_mask, d_apool, d_atok) -> (state, {"loss", "accuracy"})``.

    The batch is ids and mask [B, T] plus the host-computed identity-anchor
    arrays (``encoder.anchor_arrays``), tensors on the model's device. The step
    updates the state in place and returns it; the metrics are 0-dim tensors on
    the device (reading them waits for the step)."""
    _no_mesh(mesh)

    def step(state: TrainState, *batch):
        params = state.params()
        names = list(params)
        loss, acc = contrastive_loss(state.model, train_cfg, *batch)
        grads = torch.autograd.grad(loss, [params[k] for k in names])
        state.tx.update_(params, dict(zip(names, grads)), state.opt_state)
        return state, {"loss": loss.detach(), "accuracy": acc}

    return step


def encode_batch_with_anchors(hasher, texts: Sequence[str], enc_cfg: EncoderConfig, device=None):
    """(ids, mask, anchor_pool, anchor_tok) tensors on ``device`` for one text batch."""
    from .encoder import anchor_arrays

    dev = resolve_device(device)
    ids, mask = hasher.encode(texts)
    apool, atok = anchor_arrays(texts, enc_cfg, hasher.analyzer)
    return tuple(torch.from_numpy(a).to(dev) for a in (ids, mask, apool, atok))


def train_pairs(
    model: Encoder,
    state: TrainState,
    hasher,
    pairs,  # sequence of (query_text, positive_text)
    train_cfg: TrainConfig = TrainConfig(),
    batch_size: int = 32,
    epochs: int = 1,
    mesh=None,
    log_every: int = 0,
    device=None,
):
    """Simple host loop over pair batches (index-build-time fitting), on
    ``device`` (CUDA unless ``device="cpu"``; the model's own).

    Fewer pairs than ``batch_size`` shrink the batch instead of doing zero steps;
    a tail batch of >= 2 pairs trains too (InfoNCE needs at least one in-batch
    negative, so a 1-pair tail is dropped). Returns (state, final metrics)."""
    _no_mesh(mesh)
    dev = resolve_device(device)
    batch_size = max(2, min(batch_size, len(pairs)))
    step_fn = make_train_step(model, train_cfg)
    metrics = {}
    step = 0
    for _ in range(epochs):
        for i in range(0, len(pairs), batch_size):
            batch = pairs[i : i + batch_size]
            if len(batch) < 2:
                continue  # InfoNCE needs an in-batch negative
            q_batch = encode_batch_with_anchors(hasher, [q for q, _ in batch], model.cfg, dev)
            d_batch = encode_batch_with_anchors(hasher, [d for _, d in batch], model.cfg, dev)
            state, metrics = step_fn(state, *q_batch, *d_batch)
            if log_every and step % log_every == 0:
                print(
                    f"train_pairs step {step}: loss={float(metrics['loss']):.4f} "
                    f"acc={float(metrics.get('accuracy', 0.0)):.3f}"
                )
            step += 1
    return state, {k: float(v) for k, v in metrics.items()}
