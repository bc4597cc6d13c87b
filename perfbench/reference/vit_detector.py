"""Plain reference of the ViT detector: forward, decode, NMS + top-k, the
detection loss and the optimiser step, in float32 PyTorch.

Written from the architecture's description (ViT, arXiv 2010.11929, with
the detector's 17-slot head, its mish MLP pyramids and its composite loss)
and from the configuration file's keys alone. It imports no module of the
system under test and no JAX: the benchmark hands it the same seeded
inputs and weights that it hands the program, and it works out everything
else again.

Every matrix product and every activation a layer hands on goes through a
``Precision`` object. ``EXACT`` is float32 with TF32 off (the reference).
``fp8_e4m3()`` rounds, to float8 e4m3 under a per-tensor scale, every
value the configuration computes in bfloat16 (products' operands,
activations, their gradients): the control, the configuration computed
one precision step below its bfloat16.
"""

from __future__ import annotations

import contextlib
import math
from typing import Dict, List, Tuple

import numpy as np
import torch

EPSILON = 1e-8          # the detector's division guard
LN_EPS = 1e-3           # keras LayerNormalization's default
KERAS_EPS = 1e-7        # keras clips probabilities to [eps, 1 - eps]

SUPPORTED = {"attention_window": None, "head_scales": [1],
             "dropout": None, "use_mish": True, "ring_attention": False}


def check_supported(cfg: dict) -> None:
    """Raise for a configuration this reference does not describe."""
    for key, value in SUPPORTED.items():
        got = cfg.get(key)
        if isinstance(got, tuple):
            got = list(got)
        if got != value:
            raise NotImplementedError(
                f"the plain reference covers {key}={value!r}, not {got!r}")


# ---------------------------------------------------------------------------
# Shapes
# ---------------------------------------------------------------------------

def grid(cfg: dict) -> Tuple[int, int]:
    h, w = cfg["image_size"]
    p = cfg["patch_size"]
    return -(-h // p), -(-w // p)


def num_patches(cfg: dict) -> int:
    gh, gw = grid(cfg)
    return gh * gw


def mlp_units(cfg: dict) -> List[int]:
    d = cfg["embedding_dim"]
    return [d * 2 ** k for k in range(cfg["encoder_mlp_layers"] - 1, -1, -1)]


def head_units(cfg: dict) -> List[int]:
    u = cfg["head_last_units"]
    units = [u * 2 ** k for k in range(cfg["head_layers"] - 1, -1, -1)]
    return [x for x in units for _ in range(cfg["head_block_repeats"])]


def param_shapes(cfg: dict) -> List[Tuple[str, Tuple[int, ...]]]:
    """Every parameter's name and shape in the detector's published layout:
    dense kernels (in, out), attention q/k/v kernels (D, H, K), the output
    kernel (H, K, D), the position embedding (P, 1)."""
    check_supported(cfg)
    d, h, k = cfg["embedding_dim"], cfg["num_heads"], cfg["key_dim"]
    p = cfg["patch_size"]
    out = [("linear_projection.kernel", (p * p * 3, d)),
           ("linear_projection.bias", (d,)),
           ("position_embedding", (num_patches(cfg), 1))]
    for i in range(cfg["encoder_blocks"]):
        b = f"encoder.{i}."
        out += [(b + "ln1.gamma", (d,)), (b + "ln1.beta", (d,))]
        for name in ("query", "key", "value"):
            out += [(b + f"mha.{name}.kernel", (d, h, k)),
                    (b + f"mha.{name}.bias", (h, k))]
        out += [(b + "mha.out.kernel", (h, k, d)), (b + "mha.out.bias", (d,)),
                (b + "ln2.gamma", (d,)), (b + "ln2.beta", (d,))]
        dims = [d] + mlp_units(cfg)
        for j, (i_dim, o_dim) in enumerate(zip(dims[:-1], dims[1:])):
            out += [(b + f"mlp.{j}.kernel", (i_dim, o_dim)),
                    (b + f"mlp.{j}.bias", (o_dim,))]
    m = cfg["max_objects"]
    out += [("head_token_dense.kernel", (d, m)), ("head_token_dense.bias", (m,))]
    dims = [num_patches(cfg)] + head_units(cfg)
    for j, (i_dim, o_dim) in enumerate(zip(dims[:-1], dims[1:])):
        out += [(f"head_mlp.{j}.kernel", (i_dim, o_dim)),
                (f"head_mlp.{j}.bias", (o_dim,))]
    out += [("head_output.kernel", (dims[-1], 6)), ("head_output.bias", (6,))]
    return out


def glorot_limit(shape: Tuple[int, ...]) -> float:
    """keras glorot-uniform's limit; leading dims count as receptive field."""
    receptive = 1
    for dim in shape[:-2]:
        receptive *= dim
    fan_in, fan_out = shape[-2] * receptive, shape[-1] * receptive
    return math.sqrt(6.0 / (fan_in + fan_out))


# ---------------------------------------------------------------------------
# Precision of the matrix products
# ---------------------------------------------------------------------------

class Precision:
    """float32 throughout with TF32 off (``round`` None); or ``round``
    applied wherever the configuration's compute dtype holds a value: both
    operands of every product, and every activation a layer hands on
    (``act``: the input, the residual stream, LayerNorm, attention and
    MLP outputs, the head's), and to their gradients in the backward.
    Statistics (LayerNorm, softmax, the loss) stay float32."""

    def __init__(self, name: str, round_fn=None):
        self.name = name
        self.round = round_fn

    def mm(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        if self.round is None:
            return torch.matmul(a, b)
        return _RoundedMatmul.apply(a, b, self.round)

    def act(self, x: torch.Tensor) -> torch.Tensor:
        if self.round is None:
            return x
        return _Rounded.apply(x, self.round)


class _Rounded(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, round_fn):
        ctx.round_fn = round_fn
        return round_fn(x)

    @staticmethod
    def backward(ctx, g):
        return ctx.round_fn(g), None


class _RoundedMatmul(torch.autograd.Function):
    @staticmethod
    def forward(ctx, a, b, round_fn):
        ra, rb = round_fn(a), round_fn(b)
        ctx.save_for_backward(ra, rb)
        ctx.round_fn = round_fn
        return torch.matmul(ra, rb)

    @staticmethod
    def backward(ctx, g):
        ra, rb = ctx.saved_tensors
        rg = ctx.round_fn(g)
        ga = torch.matmul(rg, rb.transpose(-1, -2))
        gb = torch.matmul(ra.transpose(-1, -2), rg)
        # Sum broadcast batch axes back to each operand's shape.
        while ga.dim() > ra.dim():
            ga = ga.sum(0)
        while gb.dim() > rb.dim():
            gb = gb.sum(0)
        return ga, gb, None


def _round_fp8(x: torch.Tensor) -> torch.Tensor:
    """x rounded to float8 e4m3 under a per-tensor scale (amax to 448)."""
    amax = x.detach().abs().amax().float().clamp(min=1e-30)
    scale = 448.0 / amax
    return ((x * scale).to(torch.float8_e4m3fn).to(x.dtype)) / scale


EXACT = Precision("float32")


def fp8_e4m3() -> Precision:
    return Precision("fp8_e4m3", _round_fp8)


@contextlib.contextmanager
def strict_fp32():
    """float32 products with TF32 off, restored afterwards."""
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = saved


# ---------------------------------------------------------------------------
# Forward
# ---------------------------------------------------------------------------

def _mish(x):
    return x * torch.tanh(torch.nn.functional.softplus(x))


def _layer_norm(x, gamma, beta):
    mean = x.mean(dim=-1, keepdim=True)
    centered = x - mean
    var = (centered * centered).mean(dim=-1, keepdim=True)
    return centered * torch.rsqrt(var + LN_EPS) * gamma + beta


def _dense(x, w: Dict[str, torch.Tensor], name: str, prec: Precision):
    return prec.act(prec.mm(x, w[name + ".kernel"]) + w[name + ".bias"])


def normalize(images: torch.Tensor) -> torch.Tensor:
    """uint8 pixels to [-1, 1]."""
    if images.dtype == torch.uint8:
        return images.float() / 127.5 - 1.0
    return images.float()


def patchify(x: torch.Tensor, p: int) -> torch.Tensor:
    """(B, H, W, 3) -> (B, P, p*p*3), SAME padding (smaller half first),
    patches row-major over (row, col, channel)."""
    b, h, wd, c = x.shape
    gh, gw = -(-h // p), -(-wd // p)
    ph, pw = gh * p - h, gw * p - wd
    if ph or pw:
        x = torch.nn.functional.pad(
            x, (0, 0, pw // 2, pw - pw // 2, ph // 2, ph - ph // 2))
    x = x.reshape(b, gh, p, gw, p, c).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(b, gh * gw, p * p * c)


def _attention(x, w, prefix, cfg, prec: Precision):
    b, n, d = x.shape
    h, k = cfg["num_heads"], cfg["key_dim"]

    def proj(name):
        kernel = w[f"{prefix}mha.{name}.kernel"].reshape(d, h * k)
        bias = w[f"{prefix}mha.{name}.bias"].reshape(h * k)
        return (prec.mm(x, kernel) + bias).reshape(b, n, h, k).transpose(1, 2)

    q = prec.act(proj("query") / math.sqrt(cfg["key_dim"]))
    key, v = prec.act(proj("key")), prec.act(proj("value"))
    probs = torch.softmax(prec.mm(q, key.transpose(-1, -2)), dim=-1)
    out = prec.act(prec.mm(probs, v).transpose(1, 2).reshape(b, n, h * k))
    kernel = w[f"{prefix}mha.out.kernel"].reshape(h * k, d)
    return prec.act(prec.mm(out, kernel) + w[f"{prefix}mha.out.bias"])


def forward(w: Dict[str, torch.Tensor], images: torch.Tensor, cfg: dict,
            prec: Precision = EXACT) -> torch.Tensor:
    """(B, H, W, 3) uint8 or [-1, 1] images -> (B, max_objects, 6) raw
    logits, in float32."""
    check_supported(cfg)
    act = prec.act
    x = patchify(act(normalize(images)), cfg["patch_size"])
    x = act(_dense(x, w, "linear_projection", prec)
            + act(w["position_embedding"][None]))
    for i in range(cfg["encoder_blocks"]):
        prefix = f"encoder.{i}."
        side = x
        x = act(_layer_norm(x, w[prefix + "ln1.gamma"],
                            w[prefix + "ln1.beta"]))
        x = act(_attention(x, w, prefix, cfg, prec) + side)
        side = x
        x = act(_layer_norm(x, w[prefix + "ln2.gamma"],
                            w[prefix + "ln2.beta"]))
        for j in range(len(mlp_units(cfg))):
            x = act(_mish(_dense(x, w, f"{prefix}mlp.{j}", prec)))
        x = act(x + side)
    b = x.shape[0]
    x = _dense(x, w, "head_token_dense", prec)
    # The detector's head reshapes (B, P, M) to (B, M, P): no transpose.
    x = x.reshape(b, cfg["max_objects"], num_patches(cfg))
    for j in range(len(head_units(cfg))):
        x = act(_mish(_dense(x, w, f"head_mlp.{j}", prec)))
    return _dense(x, w, "head_output", prec)


def decode(logits: torch.Tensor, cfg: dict) -> torch.Tensor:
    """Logits -> (objectness, class value, cx, cy, h, w) in pixels."""
    s = torch.sigmoid(logits.float())
    h, wd = cfg["image_size"]
    return torch.stack([s[..., 0], s[..., 1] * (cfg["num_classes"] - 1),
                        s[..., 2] * wd, s[..., 3] * h, s[..., 4] * h,
                        s[..., 5] * wd], dim=-1)


def confidence(class_value: torch.Tensor) -> torch.Tensor:
    """1 at an integer class value, 0 half-way between two."""
    return (0.5 - (class_value - torch.round(class_value)).abs()) / 0.5


def scores(decoded: torch.Tensor) -> torch.Tensor:
    return decoded[..., 0] * confidence(decoded[..., 1])


def pairwise_iou(boxes: torch.Tensor) -> torch.Tensor:
    """(..., N, 4) cx, cy, h, w -> (..., N, N) IoU."""
    cx, cy, h, w = boxes.unbind(-1)
    left, right = cx - w / 2, cx + w / 2
    top, bottom = cy - h / 2, cy + h / 2
    iw = (torch.minimum(right[..., :, None], right[..., None, :])
          - torch.maximum(left[..., :, None], left[..., None, :])).clamp(min=0)
    ih = (torch.minimum(bottom[..., :, None], bottom[..., None, :])
          - torch.maximum(top[..., :, None], top[..., None, :])).clamp(min=0)
    inter = iw * ih
    area = h * w
    union = area[..., :, None] + area[..., None, :] - inter
    return inter / (union + EPSILON)


def packed(decoded: torch.Tensor, k: int = 17, iou_threshold: float = 0.5,
           score_threshold: float = 0.0) -> np.ndarray:
    """Greedy per-class NMS in score order, then top-k: per image k rows of
    (score, class, cx, cy, h, w, valid), the kept boxes first by falling
    score, then the dropped ones (score 0) in slot order."""
    decoded = decoded.detach().double().cpu()
    s = scores(decoded)
    classes = torch.round(decoded[..., 1])
    iou = pairwise_iou(decoded[..., 2:])
    b, n = decoded.shape[:2]
    out = np.zeros((b, k, 7))
    for i in range(b):
        order = sorted(range(n), key=lambda j: -float(s[i, j]))
        kept: List[int] = []
        for j in order:
            if float(s[i, j]) <= score_threshold:
                continue
            if any(classes[i, m] == classes[i, j]
                   and float(iou[i, m, j]) > iou_threshold for m in kept):
                continue
            kept.append(j)
        dropped = [j for j in range(n) if j not in kept]
        for row, j in enumerate((kept + dropped)[:k]):
            valid = j in kept
            out[i, row] = [float(s[i, j]) if valid else 0.0,
                           float(classes[i, j]),
                           *(float(v) for v in decoded[i, j, 2:]),
                           1.0 if valid else 0.0]
    return out


def detections(decoded: torch.Tensor, k: int = 17, iou_threshold: float = 0.5,
               score_threshold: float = 0.0) -> List[List[dict]]:
    """``packed``'s kept rows as per-image lists of {score, class_id,
    box}."""
    out = []
    for rows in packed(decoded, k, iou_threshold, score_threshold):
        out.append([{"score": float(r[0]), "class_id": int(r[1]),
                     "box": dict(zip(("cx", "cy", "h", "w"),
                                     (float(v) for v in r[2:6])))}
                    for r in rows if r[6] > 0.5])
    return out


# ---------------------------------------------------------------------------
# Loss and optimiser
# ---------------------------------------------------------------------------

def _ciou(label: torch.Tensor, pred: torch.Tensor) -> torch.Tensor:
    """CIoU loss (arXiv 1911.08287) of aligned (..., 4) cx, cy, h, w boxes."""
    def edges(b):
        cx, cy, h, w = b.unbind(-1)
        return cx - w / 2, cx + w / 2, cy - h / 2, cy + h / 2

    ll, lr, lt, lb = edges(label)
    pl, pr, pt, pb = edges(pred)
    iw = (torch.minimum(lr, pr) - torch.maximum(ll, pl)).clamp(min=0)
    ih = (torch.minimum(lb, pb) - torch.maximum(lt, pt)).clamp(min=0)
    inter = iw * ih
    union = label[..., 2] * label[..., 3] + pred[..., 2] * pred[..., 3] - inter
    iou = inter / (union + EPSILON)
    rho2 = ((label[..., :2] - pred[..., :2]) ** 2).sum(-1)
    ch = torch.maximum(lb, pb) - torch.minimum(lt, pt)
    cw = torch.maximum(lr, pr) - torch.minimum(ll, pl)
    c = torch.sqrt(ch * ch + cw * cw)
    r_diou = (torch.sqrt(rho2) / (c + EPSILON)) ** 2
    v = (torch.atan(label[..., 3] / (label[..., 2] + EPSILON))
         - torch.atan(pred[..., 3] / (pred[..., 2] + EPSILON))) ** 2 \
        * 4.0 / math.pi ** 2
    alpha = v / ((1.0 - iou) + v + EPSILON)
    return 1.0 - iou + r_diou + alpha * v


def loss_sums(labels: torch.Tensor, logits: torch.Tensor, cfg: dict,
              loss_cfg: dict) -> Tuple[torch.Tensor, torch.Tensor,
                                       torch.Tensor]:
    """(objectness sum over every slot, class sum, CIoU sum over the
    positive slots) of a chunk: the batch's loss divides them by the whole
    batch's slot and positive counts (``loss_from_sums``)."""
    pred = decode(logits, cfg)
    y = labels.float()
    p = pred[..., 0].clamp(KERAS_EPS, 1.0 - KERAS_EPS)
    t = y[..., 0]
    bce = -(t * torch.log(p) + (1.0 - t) * torch.log1p(-p))
    if loss_cfg["focal_binary_loss"]:
        p_t = t * p + (1.0 - t) * (1.0 - p)
        bce = (1.0 - p_t) ** loss_cfg["focal_gamma"] * bce
    positive = (t == 1.0)
    err = (pred[..., 1] - y[..., 1]).abs()[positive]
    cls = ((loss_cfg["coefficient"] * err) ** loss_cfg["exponent"]).sum()
    ciou = _ciou(y[..., 2:][positive], pred[..., 2:][positive]).sum()
    return bce.sum(), cls, ciou


def loss_from_sums(sums, slots: int, positives: int, loss_cfg: dict):
    obj, cls, ciou = sums
    total = obj / slots
    if positives > 0:
        total = (total + cls / positives * loss_cfg["weight_classification"]
                 + ciou / positives * loss_cfg["weight_ciou"])
    return total


class Adam:
    """Clip each gradient element to +-clip, then Adam (b1 0.9, b2 0.999,
    eps outside the square root) at a constant learning rate, then clip
    each weight to +-max_weight (NaN to 1)."""

    def __init__(self, train_cfg: dict, max_weight: float):
        self.lr = train_cfg["learning_rate"]
        self.clip = train_cfg["clip_gradient_value"]
        self.eps = 1e-7
        self.max_weight = max_weight
        self.t = 0
        self.mu: Dict[str, torch.Tensor] = {}
        self.nu: Dict[str, torch.Tensor] = {}

    @torch.no_grad()
    def step(self, w: Dict[str, torch.Tensor],
             grads: Dict[str, torch.Tensor]) -> None:
        self.t += 1
        c1, c2 = 1.0 - 0.9 ** self.t, 1.0 - 0.999 ** self.t
        for name, g in grads.items():
            g = g.clamp(-self.clip, self.clip)
            mu = self.mu.get(name)
            mu = 0.1 * g if mu is None else 0.9 * mu + 0.1 * g
            nu = self.nu.get(name)
            nu = 0.001 * g * g if nu is None else 0.999 * nu + 0.001 * g * g
            self.mu[name], self.nu[name] = mu, nu
            w[name] -= self.lr * (mu / c1) / (torch.sqrt(nu / c2) + self.eps)
            torch.nan_to_num_(w[name], nan=1.0, posinf=float("inf"),
                              neginf=float("-inf"))
            w[name].clamp_(-self.max_weight, self.max_weight)


def train_steps(w: Dict[str, torch.Tensor], batches, cfg: dict,
                loss_cfg: dict, train_cfg: dict, steps: int, chunk: int,
                prec: Precision = EXACT, on_step=None) -> List[float]:
    """``steps`` optimiser steps of ``w`` (updated in place) over
    ``batches`` (a list of (images, labels)), each batch's gradient summed
    over chunks of ``chunk`` images. ``on_step(t, w, grads, opt)`` runs
    after each step's gradient. Returns the losses."""
    opt = Adam(train_cfg, cfg["max_weight"] if cfg["clip_weight"] else
               float("inf"))
    losses = []
    for t in range(steps):
        images, labels = batches[t]
        slots = labels.shape[0] * labels.shape[1]
        positives = int((labels[..., 0] == 1.0).sum())
        grads = {n: torch.zeros_like(v) for n, v in w.items()}
        total = 0.0
        for start in range(0, images.shape[0], chunk):
            leaves = {n: v.detach().requires_grad_(True) for n, v in w.items()}
            logits = forward(leaves, images[start:start + chunk], cfg, prec)
            loss = loss_from_sums(
                loss_sums(labels[start:start + chunk], logits, cfg, loss_cfg),
                slots, positives, loss_cfg)
            names = list(leaves)
            got = torch.autograd.grad(loss, [leaves[n] for n in names],
                                      allow_unused=True)
            for n, g in zip(names, got):
                if g is not None:
                    grads[n] += g
            total += float(loss.detach())
        losses.append(total)
        if on_step is not None:
            on_step(t, w, grads, opt)
        opt.step(w, grads)
    return losses
