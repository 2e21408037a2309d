"""VGG and ResNet on CIFAR-10: the paper's own benchmark networks (§VI).

Counterpart of ``repro/models/cnn.py``.  Their traces (``cnn_trace``,
through ``core/trace.py``) are the offline-DSA and AutoSwap problem
instances of Table I, Table II and Figs 9-11, and they also run: on the
card, through cuDNN's convolutions.  The plans and the initialisation's
scales are the reference's; the draws are from a ``torch.Generator``, so
seeded weights differ from JAX's (``convert.cnn_params_from_jax`` carries
those over).

Where the port differs from the reference, on purpose:

- Layout.  Activations are NCHW and convolution weights OIHW, PyTorch's and
  cuDNN's layout (the reference's are NHWC and HWIO).  The head stays
  ``[cin, classes]`` and biases ``[c]``.
- Padding.  ``_conv`` pads as XLA's ``"SAME"`` does, which at stride 2
  with a 3x3 kernel on an even size is 0 before and 1 after; PyTorch's
  ``padding=1`` pads 1 on both sides and samples other positions.
- Max pooling is ``F.max_pool2d``, a torch VGG's own.  Its backward keeps
  int64 indices, twice the pooled output's bytes (the reference's
  ``reduce_window`` keeps none), which the traces' peak load carries.
  Ties route the gradient differently from JAX's, but they come after a
  ReLU, so they are zeros, whose gradient the ReLU sets to 0 anyway.
- Labels are int64, ``gather``'s index type (the reference's are int32).

VGG's parameter list holds ``None`` for each ``"M"``, as the reference's
does; the momentum tree mirrors it, and the gradient and the SGD update
skip it.
"""

from __future__ import annotations

import functools
import math
from dataclasses import dataclass

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.tree import map_tree, tree_leaves
from .layers import ShapeOnly, normal

VGG_PLANS = {
    "vgg11": [64, "M", 128, "M", 256, 256, "M", 512, 512, "M", 512, 512, "M"],
    "vgg13": [64, 64, "M", 128, 128, "M", 256, 256, "M", 512, 512, "M", 512, 512, "M"],
    "vgg16": [64, 64, "M", 128, 128, "M", 256, 256, 256, "M",
              512, 512, 512, "M", 512, 512, 512, "M"],
    "vgg19": [64, 64, "M", 128, 128, "M", 256, 256, 256, 256, "M",
              512, 512, 512, 512, "M", 512, 512, 512, 512, "M"],
}

# (block, layers per stage, bottleneck?)
RESNET_PLANS = {
    "resnet18": ([2, 2, 2, 2], False),
    "resnet34": ([3, 4, 6, 3], False),
    "resnet50": ([3, 4, 6, 3], True),
    "resnet101": ([3, 4, 23, 3], True),
}


def _conv(x, w, stride: int = 1):
    """``x`` [B, C, H, W] convolved with ``w`` [O, C, kh, kw] at ``stride``,
    padded as XLA's ``"SAME"``: each spatial size becomes ceil(size /
    stride), with the padding's odd element after."""
    pads = []
    for size, k in ((x.shape[3], w.shape[3]), (x.shape[2], w.shape[2])):  # F.pad's order
        total = max((-(-size // stride) - 1) * stride + k - size, 0)
        pads += [total // 2, total - total // 2]
    if pads[0] == pads[1] and pads[2] == pads[3]:
        return F.conv2d(x, w, stride=stride, padding=(pads[2], pads[0]))
    return F.conv2d(F.pad(x, pads), w, stride=stride)


def _max_pool(x):
    return F.max_pool2d(x, 2)


def _he(generator, shape, fan_in: int, device):
    return normal(generator, shape, math.sqrt(2.0 / fan_in), torch.float32).to(device)


def _head(generator, cin: int, num_classes: int, device):
    w = normal(generator, (cin, num_classes), 0.01, torch.float32).to(device)
    return {"b": torch.zeros(num_classes, dtype=torch.float32, device=device), "w": w}


def _logits(head, x):
    return x.mean(dim=(2, 3)) @ head["w"] + head["b"]


# ----------------------------------------------------------------- VGG
def init_vgg(generator, name: str, device, num_classes: int = 10):
    params: list = []
    cin = 3
    for item in VGG_PLANS[name]:
        if item == "M":
            params.append(None)
            continue
        w = _he(generator, (item, cin, 3, 3), 9 * cin, device)
        params.append({"b": torch.zeros(item, dtype=torch.float32, device=device), "w": w})
        cin = item
    params.append(_head(generator, cin, num_classes, device))
    return {"layers": params}


def _vgg_layers(entries, x):
    for item, p in entries:
        x = _max_pool(x) if item == "M" else F.relu(_conv(x, p["w"]) + p["b"][:, None, None])
    return x


def apply_vgg(params, x, name: str):
    x = _vgg_layers(zip(VGG_PLANS[name], params["layers"]), x)
    return _logits(params["layers"][-1], x)


# --------------------------------------------------------------- ResNet
def _init_block(generator, cin: int, cout: int, stride: int, bottleneck: bool, device):
    def w(kh, kw, ci, co):
        return _he(generator, (co, ci, kh, kw), kh * kw * ci, device)

    p = {}
    if bottleneck:
        mid = cout // 4
        p["c1"] = w(1, 1, cin, mid)
        p["c2"] = w(3, 3, mid, mid)
        p["c3"] = w(1, 1, mid, cout)
    else:
        p["c1"] = w(3, 3, cin, cout)
        p["c2"] = w(3, 3, cout, cout)
    if stride != 1 or cin != cout:
        p["proj"] = w(1, 1, cin, cout)
    return p


def _apply_block(p, x, stride: int, bottleneck: bool):
    identity = x
    if bottleneck:
        h = F.relu(_conv(x, p["c1"]))
        h = F.relu(_conv(h, p["c2"], stride))
        h = _conv(h, p["c3"])
    else:
        h = F.relu(_conv(x, p["c1"], stride))
        h = _conv(h, p["c2"])
    if "proj" in p:
        identity = _conv(x, p["proj"], stride)
    return F.relu(h + identity)


def _strides(name: str) -> list[int]:
    """Each block's stride: 2 for the first block of stages 2-4."""
    stages, _ = RESNET_PLANS[name]
    return [2 if (si > 0 and bi == 0) else 1 for si, n in enumerate(stages) for bi in range(n)]


def init_resnet(generator, name: str, device, num_classes: int = 10):
    stages, bottleneck = RESNET_PLANS[name]
    widths = [64, 128, 256, 512]
    if bottleneck:
        widths = [w * 4 for w in widths]
    couts = [cout for n, cout in zip(stages, widths) for _ in range(n)]
    stem = _he(generator, (64, 3, 3, 3), 27, device)
    cin = 64
    blocks = []
    for cout, stride in zip(couts, _strides(name)):
        blocks.append(_init_block(generator, cin, cout, stride, bottleneck, device))
        cin = cout
    head = _head(generator, cin, num_classes, device)
    return {"blocks": blocks, "head": head, "stem": stem}


def apply_resnet(params, x, name: str):
    _, bottleneck = RESNET_PLANS[name]
    x = F.relu(_conv(x, params["stem"]))
    for p, stride in zip(params["blocks"], _strides(name)):
        x = _apply_block(p, x, stride, bottleneck)
    return _logits(params["head"], x)


# ------------------------------------------------------------ train step
def _xent(logits, y):
    logp = F.log_softmax(logits, dim=-1)
    return -logp.gather(1, y[:, None]).mean()


def _segment(fn, h):
    """``fn(h)`` recomputed in backward; nothing in it draws random numbers."""
    return checkpoint(fn, h, use_reentrant=False, preserve_rng_state=False)


@dataclass
class CNN:
    name: str

    @property
    def is_vgg(self) -> bool:
        return self.name.startswith("vgg")

    def init(self, generator, device=None):
        """Random fp32 parameters drawn from ``generator`` on its device and
        placed on ``device`` (the generator's when None), so one seed gives
        the same weights on the CPU and the card."""
        device = torch.device(device) if device is not None else generator.device
        if self.is_vgg:
            return init_vgg(generator, self.name, device)
        return init_resnet(generator, self.name, device)

    def init_shapes(self):
        """``init``'s parameters as meta tensors (the reference's
        ``jax.eval_shape(cnn.init, ...)``), for tracing a step."""
        return self.init(ShapeOnly())

    @staticmethod
    def zero_momentum(params):
        """SGD's momentum for ``params``: zeros, and ``None`` where it is."""
        return map_tree(lambda t: None if t is None else torch.zeros_like(t), params)

    def apply(self, params, x):
        if self.is_vgg:
            return apply_vgg(params, x, self.name)
        return apply_resnet(params, x, self.name)

    def loss(self, params, x, y):
        return _xent(self.apply(params, x), y)

    def loss_remat(self, params, x, y, segments: int = 4):
        """Memonger-style segmented recompute: the network is cut into
        ``segments`` checkpointed chunks; only chunk boundaries survive the
        forward pass (trading compute for memory, the paper's Fig 11
        baseline)."""
        if self.is_vgg:
            entries = list(zip(VGG_PLANS[self.name], params["layers"]))
            per = max(1, len(entries) // segments)
            h = x
            for s0 in range(0, len(entries), per):
                h = _segment(functools.partial(_vgg_layers, entries[s0:s0 + per]), h)
            logits = _logits(params["layers"][-1], h)
        else:
            _, bottleneck = RESNET_PLANS[self.name]
            order = _strides(self.name)
            h = F.relu(_conv(x, params["stem"]))
            per = max(1, len(order) // segments)
            for s0 in range(0, len(order), per):
                idxs = range(s0, min(s0 + per, len(order)))

                def seg(h, idxs=idxs):
                    for i in idxs:
                        h = _apply_block(params["blocks"][i], h, order[i], bottleneck)
                    return h

                h = _segment(seg, h)
            logits = _logits(params["head"], h)
        return _xent(logits, y)

    def grads(self, params, x, y, remat: bool = False):
        """The loss's gradient as a tree like ``params`` (``None`` kept)."""
        live = map_tree(lambda t: None if t is None else t.detach().requires_grad_(True),
                        params)
        leaves = [t for t in tree_leaves(live) if t is not None]
        with torch.enable_grad():
            value = (self.loss_remat if remat else self.loss)(live, x, y)
            flat = iter(torch.autograd.grad(value, leaves))
        return map_tree(lambda t: None if t is None else next(flat), live)

    def train_step(self, params, momentum, x, y, lr=0.01, mu=0.9):
        """SGD+momentum step (the paper trains with SGD on CIFAR-10), in the
        reference's functional form: new parameter and momentum trees."""
        def upd(p, m, gg):
            m2 = mu * m + gg
            return p - lr * m2, m2

        return _sgd(params, momentum, self.grads(params, x, y), upd)

    def train_step_remat(self, params, momentum, x, y):
        """The memonger baseline's step (the paper's Fig 11), as the
        reference's ``benchmarks/common.py`` writes it: ``loss_remat``'s
        gradient, then SGD+momentum at lr 0.01 and mu 0.9, the momentum
        term computed anew for each of the two new trees."""
        return _sgd(params, momentum, self.grads(params, x, y, remat=True),
                    lambda p, m, g: (p - 0.01 * (0.9 * m + g), 0.9 * m + g))

    def trace_inputs(self, batch: int = 100):
        """CIFAR-10's images [B, 3, 32, 32] fp32 and labels [B] int64, as
        meta tensors."""
        return (torch.empty(batch, 3, 32, 32, dtype=torch.float32, device="meta"),
                torch.empty(batch, dtype=torch.long, device="meta"))


def _sgd(params, momentum, grads, upd):
    """``upd(p, m, g) -> (new p, new m)`` leaf by leaf, in the trees' order
    (the reference's ``jax.tree.map``), -> (new params, new momentum);
    ``None`` stays ``None``."""
    trees = (tree_leaves(params), tree_leaves(momentum), tree_leaves(grads))
    new = [None if p is None else upd(p, m, g) for p, m, g in zip(*trees)]

    def rebuild(k):
        it = iter(new)

        def pick(_):
            o = next(it)
            return None if o is None else o[k]

        return map_tree(pick, params)

    return rebuild(0), rebuild(1)


@functools.lru_cache(maxsize=None)
def cnn_trace(name: str, batch: int = 100, remat: bool = False):
    """One-iteration trace of ``name``'s SGD train step at CIFAR batch size,
    priced under ``GTX_1080TI``: the counterpart of the reference's
    ``benchmarks/common.py`` ``cnn_trace``, traced on fake CPU tensors (the
    same graph as CUDA's).  Cached: a caller that prices it under another
    spec does so on a copy."""
    from repro_torch.core.simulator import GTX_1080TI, assign_times
    from repro_torch.core.trace import trace_step_fn

    cnn = CNN(name)
    params = cnn.init_shapes()
    x, y = cnn.trace_inputs(batch)

    def step(p, m, xx, yy):  # four placeholders: the step's defaults stay constants
        return (cnn.train_step_remat if remat else cnn.train_step)(p, m, xx, yy)

    tr = trace_step_fn(step, params, params, x, y, device="cpu")
    assign_times(tr, GTX_1080TI)
    return tr
