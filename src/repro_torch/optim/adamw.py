"""AdamW (port of `repro/optim/adamw.py`), with the optional int8
block-quantized first/second-moment representation (8-bit-Adam-style).

`apply_updates` updates the parameters and the moments IN PLACE under
`torch.no_grad()` and returns the same trees: this is the counterpart of the
reference's `jit_train_step` buffer donation (`train/step.py`), and it keeps
the f32 scratch to two leaf-sized temporaries (a [40, 2304, 5760] leaf of
MiniCPM-2B is 2.1 GB in f32) instead of fresh copies of every tree. The
per-leaf arithmetic is the reference's, op for op, in float32.

Leaves are walked in sorted-key order, the order `jax.tree_util` flattens
dicts in, so `global_norm` sums the per-leaf squares in the reference's
order."""

from __future__ import annotations

import dataclasses

import torch

Q_BLOCK = 256


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
        z = torch.zeros(p.shape, dtype=torch.float32, device=p.device)
        return _q_encode(z) if cfg.state_dtype == "int8" else z

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


@torch.no_grad()
def apply_updates(params, grads, state, lr, cfg: AdamWConfig):
    """One AdamW step, in place. Returns (params, state, metrics) — the
    same `params` and `state` objects, updated."""
    quant = cfg.state_dtype == "int8"
    step = state["step"] + 1
    gnorm = global_norm(grads)
    clip = torch.clamp(torch.full_like(gnorm, cfg.grad_clip_norm)
                       / (gnorm + 1e-9), max=1.0)
    b1, b2 = cfg.b1, cfg.b2
    bc1 = 1 - torch.pow(b1, step.to(torch.float32))
    bc2 = 1 - torch.pow(b2, step.to(torch.float32))

    for path in leaf_paths(params):
        p = get_path(params, path)
        g = get_path(grads, path).to(torch.float32, copy=True).mul_(clip)
        m = get_path(state["m"], path)
        v = get_path(state["v"], path)
        m_f = _q_decode(m, p.shape) if quant else m
        v_f = _q_decode(v, p.shape) if quant else v
        tmp = torch.mul(g, 1 - b1)
        m_f.mul_(b1).add_(tmp)                      # b1 m + (1 - b1) g
        torch.square(g, out=tmp)
        v_f.mul_(b2).add_(tmp.mul_(1 - b2))         # b2 v + (1 - b2) g^2
        # upd = (m / bc1) / (sqrt(v / bc2) + eps), into tmp; g is scratch
        torch.div(m_f, bc1, out=tmp)
        torch.div(v_f, bc2, out=g)
        tmp.div_(g.sqrt_().add_(cfg.eps))
        # decoupled weight decay (skip 1-D params: norms, biases, scalars)
        wd = cfg.weight_decay if p.dim() >= 2 else 0.0
        g.copy_(p).mul_(wd).add_(tmp).mul_(lr)      # lr (upd + wd p)
        tmp.copy_(p).sub_(g)
        p.copy_(tmp)
        if quant:
            _set_path(state["m"], path, _q_encode(m_f))
            _set_path(state["v"], path, _q_encode(v_f))
        del g, tmp
    state["step"] = step
    return params, state, {"grad_norm": gnorm, "lr": lr}
