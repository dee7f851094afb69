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

The step also runs sharded over a dp x tp mesh (``training_mesh``,
``param_shardings``, ``shard_train_state``), as the reference's GSPMD step does, and
computes the function of the unsharded step:

- **tp**: the Megatron split of the reference's ``_param_spec``. The MLP's input
  projection, the attention's q/k/v (whole heads) and the pooled and token heads
  are column-parallel: each tp device holds a block of output rows and computes its
  block. The MLP's output projection and the attention's output projection (its
  heads axis) are row-parallel: each device multiplies its block of inputs and the
  partial sums add on the row's first device. Everything else is replicated.
- **dp**: the batch splits into contiguous slices, one per dp row (B must be a
  multiple of dp: the reference's step takes another batch, but its parameters
  come out NaN); each row runs
  the forward with its tp pieces. The pooled and token embeddings are gathered for
  one InfoNCE over the whole batch (in-batch negatives over the full batch).
- The master parameters (each piece on the first dp row's device of its tp column,
  replicated parameters on the mesh's first device) reach the other rows through
  differentiable copies, so autograd sums their gradients over dp (the
  ``nn.parallel.replicate`` idea). AdamW updates each piece; its moments are placed
  like the pieces. The step then writes the pieces back into ``state.model``, so
  the model always holds the trained weights.

One process drives every device; a device may repeat (``devices=["cpu"] * 8``).
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ..device import resolve_device
from ..parallel.mesh import DeviceMesh, _devices
from .encoder import (
    Encoder, EncoderConfig, _anchor_weights, _attend, _const, _dense, _gelu_tanh, _layer_norm,
    _masked_mean, _unit, init_encoder,
)


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
    """The encoder being trained, the optimizer's moments and count, and the
    optimizer. Unsharded, the model's parameters are the state's. Over a mesh
    (:func:`shard_train_state`) the state's parameters are ``pieces``: per
    parameter name its tp pieces (one tensor if replicated), and ``model`` holds the
    gathered weights after each step."""

    model: Encoder
    opt_state: AdamWState
    tx: AdamW = field(repr=False)
    mesh: Optional[DeviceMesh] = None
    pieces: Optional[Dict[str, List[torch.Tensor]]] = field(default=None, repr=False)

    @property
    def step(self) -> int:
        return self.opt_state.count

    def params(self) -> Dict[str, torch.Tensor]:
        """The tensors AdamW updates: the model's parameters, or over a mesh the
        pieces (``name`` for a replicated parameter, ``name[c]`` for piece ``c``)."""
        if self.pieces is None:
            return dict(self.model.named_parameters())
        return {_piece_key(k, c, len(ps)): p for k, ps in self.pieces.items()
                for c, p in enumerate(ps)}

    @torch.no_grad()
    def sync_model(self) -> None:
        """Write the pieces back into ``model`` (no-op unsharded)."""
        if self.pieces is None:
            return
        split = param_shardings(self.model, self.mesh)
        for name, p in self.model.named_parameters():
            ps = self.pieces[name]
            dim = _split_dim(split[name])
            full = ps[0] if dim is None else torch.cat([x.to(p.device) for x in ps], dim)
            p.copy_(full)


def create_train_state(
    enc_cfg: EncoderConfig,
    train_cfg: TrainConfig = TrainConfig(),
    seed: int = 0,
    mesh=None,
    device=None,
) -> Tuple[Encoder, TrainState]:
    """(model, state): a fresh :func:`~.encoder.init_encoder` model on ``device``
    (CUDA unless ``device="cpu"``; with a mesh and no device, the mesh's first) and
    AdamW over optax's warmup-cosine schedule; over ``mesh`` (a
    :func:`training_mesh`) the state is sharded (:func:`shard_train_state`). To
    warm-start a sharded state, load the weights into the model of an unsharded
    state, then shard it."""
    if device is None and mesh is not None:
        device = mesh.grid[0][0]
    model = init_encoder(enc_cfg, seed, device=resolve_device(device))
    schedule = warmup_cosine_decay_schedule(
        0.0, train_cfg.learning_rate, train_cfg.warmup_steps, train_cfg.decay_steps
    )
    tx = AdamW(schedule, weight_decay=train_cfg.weight_decay)
    state = TrainState(model=model, opt_state=tx.init(dict(model.named_parameters())), tx=tx)
    if mesh is not None:
        state = shard_train_state(state, mesh)
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
    q, q_tok = model(q_ids, q_mask)
    d, d_tok = model(d_ids, d_mask)
    return embeddings_loss(model.cfg, train_cfg, q, q_tok, d, d_tok, q_mask, q_apool, q_atok,
                           d_apool, d_atok)


def embeddings_loss(enc_cfg: EncoderConfig, train_cfg: TrainConfig, q, q_tok, d, d_tok, q_mask,
                    q_apool, q_atok, d_apool, d_atok) -> Tuple[torch.Tensor, torch.Tensor]:
    """(loss, accuracy) of the encoder's outputs for a batch: the anchor blend,
    InfoNCE at each Matryoshka width, the MaxSim term."""
    temp = train_cfg.temperature
    q, q_tok = training_blend(enc_cfg, q, q_tok, q_apool, q_atok)
    d, d_tok = training_blend(enc_cfg, d, d_tok, d_apool, d_atok)
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
    the device (reading them waits for the step). Over ``mesh`` the state must be
    sharded over it (:func:`shard_train_state`) and a batch that its dp rows do not
    divide raises."""
    if mesh is not None:
        return _sharded_step(train_cfg, mesh)

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
    negative, so a 1-pair tail is dropped). Over ``mesh`` the state is sharded
    first if it is not, and a batch that its dp rows do not divide raises.
    Returns (state, final metrics)."""
    if mesh is not None and state.mesh is None:
        state = shard_train_state(state, mesh)
    dev = resolve_device(mesh.grid[0][0] if device is None and mesh is not None else device)
    batch_size = max(2, min(batch_size, len(pairs)))
    step_fn = make_train_step(model, train_cfg, mesh)
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


# ---------------------------------------------------------------------------
# the dp x tp mesh
# ---------------------------------------------------------------------------


def training_mesh(n_devices: Optional[int] = None, tp: int = 2, devices=None) -> DeviceMesh:
    """dp x tp mesh (axes ``("dp", "tp")``) over ``devices`` (default: every
    visible CUDA card; a device may repeat), ``tp = min(tp, n)``."""
    devs = _devices(devices)
    n = n_devices or len(devs)
    tp = min(tp, n)
    dp = n // tp
    return DeviceMesh([devs[r * tp:(r + 1) * tp] for r in range(dp)], ("dp", "tp"))


def _spec(name: str) -> Tuple:
    """The reference's ``_param_spec`` in this module's weight layout ([out, in]):
    the tp-split axis of a weight, None elsewhere; () for a replicated parameter."""
    if not name.endswith(".weight"):
        return ()
    if "mlp_in" in name:
        return ("tp", None)  # column-parallel: output rows
    if "mlp_out" in name:
        return (None, "tp")  # row-parallel: input columns
    if ".attn." in name:
        # q/k/v: whole heads (head-major output rows); out: its heads axis (inputs)
        return (None, "tp") if ".attn.out." in name else ("tp", None)
    if name in ("pool_proj.weight", "token_proj.weight"):
        return ("tp", None)
    return ()


def _split_dim(spec: Tuple) -> Optional[int]:
    return spec.index("tp") if "tp" in spec else None


def _piece_key(name: str, c: int, n: int) -> str:
    return name if n == 1 else f"{name}[{c}]"


def param_shardings(params, mesh: DeviceMesh) -> Dict[str, Tuple]:
    """Per parameter name (of an :class:`Encoder` or a name -> tensor mapping), the
    axis of the mesh each dimension splits over: ``("tp", None)`` for a
    column-parallel weight, ``(None, "tp")`` for a row-parallel one, ``()`` for a
    replicated parameter."""
    names = dict(params.named_parameters()) if isinstance(params, torch.nn.Module) else params
    return {k: _spec(k) if mesh.shape["tp"] > 1 else () for k in names}


def _split(t: torch.Tensor, dim: Optional[int], mesh: DeviceMesh) -> List[torch.Tensor]:
    """A master tensor's pieces on the first dp row's devices (one piece, on the
    mesh's first device, when replicated)."""
    row = mesh.grid[0]
    if dim is None:
        return [t.detach().to(row[0]).clone()]
    if t.shape[dim] % len(row):
        raise ValueError(f"a dimension of {t.shape[dim]} does not split over tp = {len(row)}")
    return [x.detach().to(dev).clone().contiguous()
            for x, dev in zip(torch.chunk(t, len(row), dim), row)]


def shard_train_state(state: TrainState, mesh: DeviceMesh) -> TrainState:
    """``state`` over ``mesh``: its model's parameters and the AdamW moments split
    into tp pieces by :func:`param_shardings` (replicated ones whole), each piece on
    the first dp row's device of its tp column. The count carries over."""
    specs = param_shardings(state.model, mesh)
    if state.model.cfg.n_heads % mesh.shape["tp"]:
        raise ValueError(f"{state.model.cfg.n_heads} heads do not split over tp = {mesh.shape['tp']}")
    pieces, mu, nu = {}, {}, {}
    src = state.params() if state.pieces is None else None
    if src is None:
        raise ValueError("the state is sharded already")
    for name, p in src.items():
        dim = _split_dim(specs[name])
        ps = _split(p, dim, mesh)
        pieces[name] = [x.requires_grad_(True) for x in ps]
        n = len(ps)
        for store, moments in ((mu, state.opt_state.mu), (nu, state.opt_state.nu)):
            for c, x in enumerate(_split(moments[name], dim, mesh)):
                store[_piece_key(name, c, n)] = x
    opt = AdamWState(mu=mu, nu=nu, count=state.opt_state.count)
    return TrainState(model=state.model, opt_state=opt, tx=state.tx, mesh=mesh, pieces=pieces)


def _row_params(state: TrainState, r: int) -> Dict[str, List[torch.Tensor]]:
    """Data row ``r``'s view of the master parameters: per name its pieces on the
    row's tp devices, a replicated one on the row's first device (differentiable
    copies; the masters themselves on row 0)."""
    row = state.mesh.grid[r]
    return {k: [p.to(row[c] if len(ps) > 1 else row[0]) for c, p in enumerate(ps)]
            for k, ps in state.pieces.items()}


def _column(x: torch.Tensor, weights: List[torch.Tensor], bias: torch.Tensor,
            devs: List[torch.device]) -> List[torch.Tensor]:
    """Column-parallel dense layer: on each tp device its block of output columns
    (its weight rows, its slice of the replicated bias)."""
    out, lo = [], 0
    for w, dev in zip(weights, devs):
        hi = lo + w.shape[0]
        out.append(_dense(x.to(dev), w, bias[lo:hi].to(dev)))
        lo = hi
    return out


def _row_parallel(parts: List[torch.Tensor], weights: List[torch.Tensor], bias: torch.Tensor,
                  home: torch.device) -> torch.Tensor:
    """Row-parallel dense layer: each device's partial product of its input block,
    added in tp order on ``home``, then the bias (``_dense``'s rounding per part)."""
    acc = None
    for x, w in zip(parts, weights):
        y = F.linear(x, w.to(x.dtype)).to(home)
        acc = y if acc is None else acc + y
    return acc + bias.to(acc.dtype)


def _sharded_forward(cfg: EncoderConfig, P: Dict[str, List[torch.Tensor]],
                     devs: List[torch.device], ids: torch.Tensor, mask: torch.Tensor):
    """``Encoder.forward`` of one dp row over its tp devices ``devs``, op for op
    with the encoder's own sub-layer code. Returns (pooled, tok) on ``devs[0]``."""
    dt = cfg.compute_dtype
    home = devs[0]
    tp = len(devs)
    t = ids.shape[1]
    masks = [mask.to(dev) for dev in devs]
    x = F.embedding(ids.long(), P["tok_embed"][0]).to(dt) + P["pos_embed"][0][:t].to(dt)
    for i in range(cfg.n_layers):
        b = f"blocks.{i}."
        h = _layer_norm(x, P[b + "ln_attn.scale"][0], P[b + "ln_attn.bias"][0]).to(dt)
        q, k, v = (_column(h, P[b + f"attn.{n}.weight"], P[b + f"attn.{n}.bias"][0], devs)
                   for n in ("query", "key", "value"))
        heads = [_attend(qc, kc, vc, mc, cfg.n_heads // tp)
                 for qc, kc, vc, mc in zip(q, k, v, masks)]
        x = x + _row_parallel(heads, P[b + "attn.out.weight"], P[b + "attn.out.bias"][0], home)
        h = _layer_norm(x, P[b + "ln_mlp.scale"][0], P[b + "ln_mlp.bias"][0]).to(dt)
        hidden = [_gelu_tanh(u) for u in _column(h, P[b + "mlp_in.weight"],
                                                   P[b + "mlp_in.bias"][0], devs)]
        x = x + _row_parallel(hidden, P[b + "mlp_out.weight"], P[b + "mlp_out.bias"][0], home)
    x = _layer_norm(x, P["ln_final.scale"][0], P["ln_final.bias"][0])
    pooled = _column(_masked_mean(x, mask), P["pool_proj.weight"], P["pool_proj.bias"][0], devs)
    pooled = _unit(torch.cat([p.to(home) for p in pooled], -1).float())
    tok = _column(x, P["token_proj.weight"], P["token_proj.bias"][0], devs)
    tok = _unit(torch.cat([p.to(home) for p in tok], -1).float())
    return pooled, tok * mask[..., None].float()


def _sharded_step(train_cfg: TrainConfig, mesh: DeviceMesh):
    dp = mesh.shape["dp"]
    home = mesh.grid[0][0]

    def step(state: TrainState, q_ids, q_mask, q_apool, q_atok, d_ids, d_mask, d_apool, d_atok):
        if state.mesh is not mesh:
            raise ValueError("the state is not sharded over this mesh (shard_train_state)")
        b = q_ids.shape[0]
        if b % dp or d_ids.shape[0] != b:
            # the reference's GSPMD step takes such a batch but its parameters
            # and moments come out NaN: refuse it instead
            raise ValueError(f"a batch of {b} does not split over dp = {dp}")
        per = b // dp
        cfg = state.model.cfg
        outs = []
        for r in range(dp):
            devs = list(mesh.grid[r])
            P = _row_params(state, r)
            sl = slice(r * per, (r + 1) * per)
            outs.append((
                *_sharded_forward(cfg, P, devs, q_ids[sl].to(devs[0]), q_mask[sl].to(devs[0])),
                *_sharded_forward(cfg, P, devs, d_ids[sl].to(devs[0]), d_mask[sl].to(devs[0])),
            ))
        q, q_tok, d, d_tok = (torch.cat([o[j].to(home) for o in outs], 0) for j in range(4))
        loss, acc = embeddings_loss(
            cfg, train_cfg, q, q_tok, d, d_tok, *(x.to(home) for x in (q_mask, q_apool, q_atok, d_apool, d_atok))
        )
        params = state.params()
        names = list(params)
        grads = torch.autograd.grad(loss, [params[k] for k in names])
        state.tx.update_(params, dict(zip(names, grads)), state.opt_state)
        state.sync_model()
        return state, {"loss": loss.detach(), "accuracy": acc}

    return step
