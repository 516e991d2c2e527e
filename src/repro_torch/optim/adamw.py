"""AdamW (port of `repro/optim/adamw.py`), with the optional int8
block-quantized first/second-moment representation (8-bit-Adam-style).

`apply_updates` updates the parameters and the moments IN PLACE under
`torch.no_grad()` and returns the same trees: this is the counterpart of the
reference's `jit_train_step` buffer donation (`train/step.py`). A large
leaf is updated in slices of its leading axis (`_row_chunks`, at most
`CHUNK_ELEMENTS` each, a whole number of int8 blocks), so the f32 scratch
is a few chunk-sized temporaries, not leaf-sized ones: RWKV6-7B's stacked
`cm_wk` leaf, [32, 4096, 14336], is 7.5 GB in f32, and the int8 moments'
decode and encode would hold five or six such temporaries at once. The
update is elementwise and a chunk's int8 blocks are the leaf's own, so the
result is the same bits as one pass over the leaf. The arithmetic is the
reference's, op for op, in float32.

Leaves are walked in sorted-key order, the order `jax.tree_util` flattens
dicts in, so `global_norm` sums the per-leaf squares in the reference's
order."""

from __future__ import annotations

import dataclasses
import math

import torch

Q_BLOCK = 256
CHUNK_ELEMENTS = 1 << 26     # elements of one slice of a leaf's update


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip_norm: float = 1.0
    state_dtype: str = "float32"      # float32 | int8


# -- tree walking in the reference's (sorted-key) leaf order ------------------

def leaf_paths(tree, prefix=()):
    """Key paths of the leaves of nested dicts, in sorted-key order."""
    if isinstance(tree, dict):
        out = []
        for k in sorted(tree):
            out.extend(leaf_paths(tree[k], prefix + (k,)))
        return out
    return [prefix]


def get_path(tree, path):
    for k in path:
        tree = tree[k]
    return tree


def _set_path(tree, path, value):
    for k in path[:-1]:
        tree = tree[k]
    tree[path[-1]] = value


# -- int8 moment codec --------------------------------------------------------

def _q_encode(x):
    """Per-256-block absmax int8 codes (round half to even) and f32
    scales [n_blocks, 1]."""
    flat = x.reshape(-1)
    pad = (-flat.numel()) % Q_BLOCK
    if pad:
        flat = torch.cat([flat, flat.new_zeros(pad)])
    blocks = flat.reshape(-1, Q_BLOCK)
    absmax = blocks.abs().amax(dim=1, keepdim=True)
    scale = torch.where(absmax > 0, absmax / 127.0, 1.0)
    q = torch.clamp(torch.round(blocks / scale), -127, 127).to(torch.int8)
    return {"q": q, "scale": scale.float()}


def _q_decode(enc, shape):
    n = 1
    for d in shape:
        n *= d
    return (enc["q"].float() * enc["scale"]).reshape(-1)[:n].reshape(shape)


# -- init / update --------------------------------------------------------------

def _map(fn, tree):
    if isinstance(tree, dict):
        return {k: _map(fn, v) for k, v in tree.items()}
    return fn(tree)


def init_state(params, cfg: AdamWConfig):
    def zero_moment(p):
        if cfg.state_dtype != "int8":
            return torch.zeros(p.shape, dtype=torch.float32, device=p.device)
        # the codes of zeros (`_q_encode` gives q 0, scale 1 to an all-zero
        # block), made without a leaf-sized f32 temporary
        n_blocks = -(-p.numel() // Q_BLOCK)
        return {"q": torch.zeros((n_blocks, Q_BLOCK), dtype=torch.int8,
                                 device=p.device),
                "scale": torch.ones((n_blocks, 1), dtype=torch.float32,
                                    device=p.device)}

    first = get_path(params, leaf_paths(params)[0])
    return {"step": torch.zeros((), dtype=torch.int32, device=first.device),
            "m": _map(zero_moment, params),
            "v": _map(zero_moment, params)}


def global_norm(tree):
    """sqrt of the sum of every leaf's f32 sum of squares, leaves in the
    reference's order."""
    total = None
    for path in leaf_paths(tree):
        sq = get_path(tree, path).to(torch.float32, copy=True).square_().sum()
        total = sq if total is None else total + sq
    return torch.sqrt(total)


def _row_chunks(p):
    """Slices of `p`'s leading axis that together cover it, each at most
    CHUNK_ELEMENTS (or one row) and a whole number of Q_BLOCK blocks; the
    whole leaf where it is small, 1-D, or not whole blocks."""
    if p.dim() < 2 or p.numel() <= CHUNK_ELEMENTS or p.numel() % Q_BLOCK:
        return [slice(None)]
    row = p[0].numel()
    step = Q_BLOCK // math.gcd(row, Q_BLOCK)     # rows that fill blocks
    rows = max(step, CHUNK_ELEMENTS // row // step * step)
    if rows >= p.shape[0]:
        return [slice(None)]
    return [slice(i, i + rows) for i in range(0, p.shape[0], rows)]


def _direction(g, m_f, v_f, clip, bc1, bc2, cfg: AdamWConfig):
    """The moments' update of one leaf or slice, in place (g, the
    gradient, is read; m_f and v_f, f32 moments, written), and AdamW's
    direction (m / bc1) / (sqrt(v / bc2) + eps): returns (the direction,
    a scratch tensor of its shape)."""
    b1, b2 = cfg.b1, cfg.b2
    g = g.to(torch.float32, copy=True).mul_(clip)
    tmp = torch.mul(g, 1 - b1)
    m_f.mul_(b1).add_(tmp)                      # b1 m + (1 - b1) g
    torch.square(g, out=tmp)
    v_f.mul_(b2).add_(tmp.mul_(1 - b2))         # b2 v + (1 - b2) g^2
    # upd = (m / bc1) / (sqrt(v / bc2) + eps), into tmp; g is scratch
    torch.div(m_f, bc1, out=tmp)
    torch.div(v_f, bc2, out=g)
    tmp.div_(g.sqrt_().add_(cfg.eps))
    return tmp, g


def _apply(p, upd, scratch, lr, wd: float) -> None:
    """p - lr (upd + wd p), written into p (`upd` and `scratch`, f32 of
    p's shape, are overwritten)."""
    scratch.copy_(p).mul_(wd).add_(upd).mul_(lr)      # lr (upd + wd p)
    upd.copy_(p).sub_(scratch)
    p.copy_(upd)


def _update(p, g, m_f, v_f, clip, bc1, bc2, lr, cfg: AdamWConfig,
            wd: float) -> None:
    """The AdamW update of one leaf or slice, in place: g (the gradient)
    is read, m_f and v_f (f32 moments) and p written."""
    upd, scratch = _direction(g, m_f, v_f, clip, bc1, bc2, cfg)
    _apply(p, upd, scratch, lr, wd)


def step_scalars(step, gnorm, cfg: AdamWConfig):
    """(the step count after this update, the clip factor from the global
    norm `gnorm`, the two bias corrections): what every leaf's update
    reads."""
    step = step + 1
    clip = torch.clamp(torch.full_like(gnorm, cfg.grad_clip_norm)
                       / (gnorm + 1e-9), max=1.0)
    bc1 = 1 - torch.pow(cfg.b1, step.to(torch.float32))
    bc2 = 1 - torch.pow(cfg.b2, step.to(torch.float32))
    return step, clip, bc1, bc2


@torch.no_grad()
def int8_rows_direction(g_rows, m, v, clip, bc1, bc2, cfg: AdamWConfig):
    """The int8 moments' update on rows of a leaf's flat 256-element
    blocks, in place, and AdamW's direction on the same rows: `g_rows`
    [n, Q_BLOCK] f32 is the gradient's (zero past the leaf's end), `m`
    and `v` the moments' `{"q", "scale"}` on the same rows. Decoded,
    updated and encoded a slice of whole blocks at a time, so the codes
    are those the whole leaf's update makes. Returns the direction rows
    [n, Q_BLOCK] f32 (the placed train step sends them to the param's
    blocks, `apply_direction`)."""
    out = torch.empty_like(g_rows)
    step = max(1, CHUNK_ELEMENTS // Q_BLOCK)
    for r in range(0, g_rows.shape[0], step):
        sl = slice(r, r + step)
        m_f, v_f = (e["q"][sl].float() * e["scale"][sl] for e in (m, v))
        upd, _ = _direction(g_rows[sl], m_f, v_f, clip, bc1, bc2, cfg)
        out[sl] = upd
        for e, f in zip((m, v), (m_f, v_f)):
            new = _q_encode(f)
            e["q"][sl].copy_(new["q"])
            e["scale"][sl].copy_(new["scale"])
    return out


@torch.no_grad()
def apply_direction(p, upd, lr, cfg: AdamWConfig) -> None:
    """p - lr (upd + wd p) into `p` (a leaf or its block; `upd`, f32 of
    its shape, the direction from `int8_rows_direction`, is overwritten),
    in slices of `p`'s leading axis: the bits of `apply_updates`' last
    step. wd is decayed on 2-D and up."""
    wd = cfg.weight_decay if p.dim() >= 2 else 0.0
    for sl in _row_chunks(p):
        u = upd[sl]
        _apply(p[sl], u, torch.empty_like(u), lr, wd)


@torch.no_grad()
def apply_updates(params, grads, state, lr, cfg: AdamWConfig,
                  grad_norm=None):
    """One AdamW step, in place. Returns (params, state, metrics) — the
    same `params` and `state` objects, updated. `grad_norm` is the global
    norm of the whole gradient where `grads` are blocks of it (the placed
    train step's: each rank updates its blocks of the params and f32
    moments, elementwise); by default `global_norm(grads)`."""
    quant = cfg.state_dtype == "int8"
    gnorm = global_norm(grads) if grad_norm is None else grad_norm
    step, clip, bc1, bc2 = step_scalars(state["step"], gnorm, cfg)

    for path in leaf_paths(params):
        p = get_path(params, path)
        g = get_path(grads, path)
        m = get_path(state["m"], path)
        v = get_path(state["v"], path)
        # decoupled weight decay (skip 1-D params: norms, biases, scalars)
        wd = cfg.weight_decay if p.dim() >= 2 else 0.0
        chunks = _row_chunks(p)
        if not quant:
            for sl in chunks:
                _update(p[sl], g[sl], m[sl], v[sl], clip, bc1, bc2, lr, cfg,
                        wd)
        elif len(chunks) == 1:
            m_f, v_f = _q_decode(m, p.shape), _q_decode(v, p.shape)
            _update(p, g, m_f, v_f, clip, bc1, bc2, lr, cfg, wd)
            _set_path(state["m"], path, _q_encode(m_f))
            _set_path(state["v"], path, _q_encode(v_f))
        else:
            row = p[0].numel()
            for sl in chunks:               # the slice's int8 blocks
                rows = slice(sl.start * row // Q_BLOCK,
                             min(sl.stop, p.shape[0]) * row // Q_BLOCK)
                ps = p[sl]
                enc = [{k: e[k][rows] for k in ("q", "scale")}
                       for e in (m, v)]
                m_f, v_f = (_q_decode(e, ps.shape) for e in enc)
                _update(ps, g[sl], m_f, v_f, clip, bc1, bc2, lr, cfg, wd)
                for e, f in zip(enc, (m_f, v_f)):
                    new = _q_encode(f)
                    e["q"].copy_(new["q"])
                    e["scale"].copy_(new["scale"])
    state["step"] = step
    return params, state, {"grad_norm": gnorm, "lr": lr}
