"""Generic image-segmentation U-Net and its `Trainer` (port of
`avsi/models/unet_generic.py`, the reference's tf_unet-style network).

Configurable depth, two 3x3 VALID convs per level with 2x2 max-pool
downsampling, 2x transposed-conv upsampling with crop-and-concat skips, a
1x1 head, pixel-wise softmax and cross-entropy.  The params keep the
reference's tree and HWIO weights (`checkpoints.params_from_flat` carries
JAX weights across); `forward` takes and returns NHWC like the
reference's and runs NCHW inside.

`_deconv2x` is `lax.conv_transpose(..., "SAME")` without
`transpose_kernel`: per axis, with k = s = 2, `out[2i] = x[i] w[1]` and
`out[2i+1] = x[i] w[0]`.  `F.conv_transpose2d(stride=2)` computes
`out[2i+j] = x[i] W[j]`, so its weight is `w` flipped in both spatial
axes, in (in, out, kh, kw) order.

`Trainer` trains with momentum SGD under a staircase exponential decay
(`lr0 * decay ** (count // training_iters)`, optax's `trace` without
Nesterov: `torch.optim.SGD(momentum=m, dampening=0)`) or constant-lr
Adam, writes per-step TensorBoard scalars, a prediction PNG per epoch and
a checkpoint with its optimizer state and step (the reference's keys), and
resumes from it.
"""

from __future__ import annotations

import math
import os

import numpy as np
import torch
import torch.nn.functional as F

from avsi_torch.device import resolve_device
from avsi_torch.models import core
from avsi_torch.train import checkpoints
from avsi_torch.train import state as state_lib
from avsi_torch.train.tb import SummaryWriter, _png_grayscale


def _conv_init(gen: torch.Generator, k: int, cin: int, cout: int) -> dict:
    return {"w": core.truncated_normal_init(gen, (k, k, cin, cout), math.sqrt(2.0 / (k * k * cin))),
            "b": torch.full((cout,), 0.1, dtype=torch.float32)}


def init(gen: torch.Generator, channels_in: int = 1, n_classes: int = 2, layers: int = 3,
         features_root: int = 16, filter_size: int = 3, device=None) -> dict:
    params: dict = {"down": [], "up": []}
    cin, feats = channels_in, features_root
    for _ in range(layers):
        params["down"].append({"conv1": _conv_init(gen, filter_size, cin, feats),
                               "conv2": _conv_init(gen, filter_size, feats, feats)})
        cin, feats = feats, feats * 2
    feats //= 2
    for _ in range(layers - 1):
        params["up"].append({
            "deconv": _conv_init(gen, 2, feats, feats // 2),  # HWIO
            "conv1": _conv_init(gen, filter_size, feats, feats // 2),
            "conv2": _conv_init(gen, filter_size, feats // 2, feats // 2),
        })
        feats //= 2
    params["head"] = _conv_init(gen, 1, feats, n_classes)
    return core.tree_to(params, device or "cpu")


def _conv(p: dict, x: torch.Tensor) -> torch.Tensor:
    """VALID conv of NCHW `x` with the HWIO weight `p["w"]`, plus bias."""
    return F.conv2d(x, p["w"].permute(3, 2, 0, 1), p["b"])


def _deconv2x(p: dict, x: torch.Tensor) -> torch.Tensor:
    """The reference's 2x transposed conv (see the module docstring)."""
    w = torch.flip(p["w"], dims=(0, 1)).permute(2, 3, 0, 1)
    return F.conv_transpose2d(x, w, p["b"], stride=2)


def _crop_and_concat(skip: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Center-crop `skip` to x's H and W, then concat on channels."""
    dh = (skip.shape[2] - x.shape[2]) // 2
    dw = (skip.shape[3] - x.shape[3]) // 2
    return torch.cat([skip[:, :, dh:dh + x.shape[2], dw:dw + x.shape[3]], x], dim=1)


def forward(params: dict, x: torch.Tensor, keep_prob: float = 1.0,
            gen: torch.Generator | None = None) -> torch.Tensor:
    """(B, H, W, C) -> logits (B, H', W', n_classes); VALID convs shrink.

    keep_prob < 1 drops out after every conv + bias, before the ReLU, with
    masks drawn from `gen` (none without one, as in evaluation)."""
    def drop(h):
        if keep_prob >= 1.0 or gen is None:
            return h
        keep = torch.rand(h.shape, generator=gen, device=h.device) < keep_prob
        return torch.where(keep, h / keep_prob, 0.0)

    x = x.permute(0, 3, 1, 2)
    skips = []
    for i, level in enumerate(params["down"]):
        x = F.relu(drop(_conv(level["conv1"], x)))
        x = F.relu(drop(_conv(level["conv2"], x)))
        if i < len(params["down"]) - 1:
            skips.append(x)
            x = F.max_pool2d(x, 2)
    for level in params["up"]:
        x = F.relu(_deconv2x(level["deconv"], x))
        x = _crop_and_concat(skips.pop(), x)
        x = F.relu(drop(_conv(level["conv1"], x)))
        x = F.relu(drop(_conv(level["conv2"], x)))
    return _conv(params["head"], x).permute(0, 2, 3, 1)


def pixel_wise_softmax(logits: torch.Tensor) -> torch.Tensor:
    return torch.softmax(logits, dim=-1)


def cross_entropy(labels_onehot: torch.Tensor, probs: torch.Tensor) -> torch.Tensor:
    return -torch.mean(labels_onehot * torch.log(torch.clamp(probs, 1e-10, 1.0)))


def loss(params: dict, x: torch.Tensor, labels_onehot: torch.Tensor) -> torch.Tensor:
    return cross_entropy(labels_onehot, pixel_wise_softmax(forward(params, x)))


def crop_to_shape(data, shape):
    """Center-crop (B, H, W, ...) to the target H, W."""
    data = np.asarray(data)
    dh = (data.shape[1] - shape[1]) // 2
    dw = (data.shape[2] - shape[2]) // 2
    return data[:, dh:dh + shape[1], dw:dw + shape[2]]


def error_rate(predictions, labels) -> float:
    """Percent pixel error of dense predictions against 1-hot labels."""
    predictions, labels = np.asarray(predictions), np.asarray(labels)
    hits = np.sum(np.argmax(predictions, 3) == np.argmax(labels, 3))
    return 100.0 - 100.0 * hits / (
        predictions.shape[0] * predictions.shape[1] * predictions.shape[2])


def _to_gray8(img: np.ndarray) -> np.ndarray:
    img = np.asarray(img, np.float64)
    img -= img.min()
    if img.max() != 0:
        img /= img.max()
    return (img * 255).astype(np.uint8)


def combine_img_prediction(data, gt, pred) -> np.ndarray:
    """Input | ground truth | prediction strips side by side, one grayscale
    image."""
    pred = np.asarray(pred)
    ny = pred.shape[2]
    strips = [
        _to_gray8(crop_to_shape(data, pred.shape)[..., 0].reshape(-1, ny)),
        _to_gray8(crop_to_shape(np.asarray(gt)[..., 1:2], pred.shape)[..., 0].reshape(-1, ny)),
        _to_gray8(pred[..., 1].reshape(-1, ny)),
    ]
    return np.concatenate(strips, axis=1)


def _accuracy(probs: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    return torch.mean((torch.argmax(probs, 3) == torch.argmax(y, 3)).float())


class Trainer:
    """Trains a generic U-Net (the reference's `Trainer`): the params move
    to `device` (default cuda) and are updated in place."""

    def __init__(self, params: dict, batch_size: int = 1, verification_batch_size: int = 4,
                 optimizer: str = "momentum", opt_kwargs: dict | None = None, device=None):
        self.device = resolve_device(device)
        self.params = core.tree_to(params, self.device)
        self.batch_size = batch_size
        self.verification_batch_size = verification_batch_size
        self.optimizer = optimizer
        self.opt_kwargs = dict(opt_kwargs or {})

    def _make_optimizer(self, training_iters: int):
        """(torch optimizer over the params' leaves, lr schedule of the
        update count)."""
        leaves = list(checkpoints.named_leaves(self.params).values())
        if self.optimizer == "momentum":
            lr = self.opt_kwargs.get("learning_rate", 0.2)
            decay = self.opt_kwargs.get("decay_rate", 0.95)
            momentum = self.opt_kwargs.get("momentum", 0.2)
            opt = torch.optim.SGD(leaves, lr=lr, momentum=momentum, dampening=0.0)
            return opt, (lambda count: lr * decay ** (count // training_iters))
        lr = self.opt_kwargs.get("learning_rate", 0.001)
        opt = torch.optim.Adam(leaves, lr=lr, betas=state_lib.ADAM_BETAS, eps=state_lib.ADAM_EPS)
        return opt, (lambda count: lr)

    def _opt_flat(self) -> dict:
        """The optimizer state in the reference `Trainer`'s optax keys: one
        chain (`0/trace/<leaf>`, `1/count`; adam `0/count`, `0/mu/<leaf>`,
        `0/nu/<leaf>`), where `train()`'s state sits one chain deeper."""
        flat = {k[2:]: v for k, v in checkpoints.opt_state_to_flat(self.state).items()}
        if self.optimizer != "momentum":
            del flat["1/count"]  # optax's adam at a constant rate keeps one count
        return flat

    def _save(self, output_path: str) -> None:
        prefix = checkpoints.save_checkpoint(output_path, "model", self.params,
                                             step=self.state.step)
        np.savez(prefix + ".opt", **self._opt_flat())

    def _restore(self, output_path: str) -> None:
        """Params, step and optimizer state from `<output_path>/model`."""
        params, self.state.step = checkpoints.restore_checkpoint(output_path, "model",
                                                                 self.device, self.params)
        with torch.no_grad():
            for leaf, value in zip(checkpoints.named_leaves(self.params).values(),
                                   checkpoints.named_leaves(params).values()):
                leaf.copy_(value)
        path = os.path.join(output_path, "model.opt.npz")
        if os.path.isfile(path):
            with np.load(path) as data:
                flat = {"0/" + k: data[k] for k in data.files}
            flat.setdefault("0/1/count", flat.get("0/0/count"))
            checkpoints.load_opt_state(self.state, flat)

    def train(self, data_provider, output_path: str, training_iters: int = 10, epochs: int = 100,
              dropout: float = 0.75, display_step: int = 1, restore: bool = False,
              prediction_path: str = "prediction") -> str:
        """data_provider(n) -> (x, y_onehot) numpy NHWC batches; `dropout`
        is the keep probability.  Returns the checkpoint's path."""
        os.makedirs(output_path, exist_ok=True)
        os.makedirs(prediction_path, exist_ok=True)
        save_path = os.path.join(output_path, "model.npz")
        if epochs == 0:
            return save_path
        for leaf in checkpoints.named_leaves(self.params).values():
            leaf.requires_grad_(True)
        opt, sched = self._make_optimizer(training_iters)
        self.state = state_lib.TrainState(self.params, opt)
        if restore:
            self._restore(output_path)
        params, dev, keep_prob = self.params, self.device, float(dropout)

        def tensor(a):
            return torch.as_tensor(np.asarray(a, np.float32)).to(dev)

        @torch.no_grad()
        def store_prediction(x, y, name):
            pred = pixel_wise_softmax(forward(params, tensor(x))).cpu().numpy()
            y_c = crop_to_shape(y, pred.shape)
            l = float(cross_entropy(torch.from_numpy(np.asarray(y_c, np.float32)),
                                    torch.from_numpy(pred)))
            print(f"Verification error= {error_rate(pred, y_c):.1f}%, loss= {l:.4f}", flush=True)
            with open(os.path.join(prediction_path, f"{name}.png"), "wb") as f:
                f.write(_png_grayscale(combine_img_prediction(x, y, pred)))
            return pred.shape

        gen = torch.Generator(device=dev).manual_seed(int(self.opt_kwargs.get("seed", 0)))
        test_x, test_y = data_provider(self.verification_batch_size)
        pred_shape = store_prediction(test_x, test_y, "_init")
        tb = SummaryWriter(output_path)
        for epoch in range(epochs):
            total_loss = torch.zeros((), device=dev)  # read once per epoch
            for _ in range(training_iters):
                batch_x, batch_y = data_provider(self.batch_size)
                bx, by = tensor(batch_x), tensor(crop_to_shape(batch_y, pred_shape))
                step = self.state.step
                opt.zero_grad(set_to_none=True)
                l = cross_entropy(by, pixel_wise_softmax(forward(params, bx, keep_prob, gen)))
                l.backward()
                for group in opt.param_groups:
                    group["lr"] = sched(step)
                opt.step()
                self.state.step = step + 1
                if step % display_step == 0:
                    with torch.no_grad():  # the dropout-free minibatch stats
                        probs = pixel_wise_softmax(forward(params, bx))
                        sl, sacc = float(cross_entropy(by, probs)), float(_accuracy(probs, by))
                    tb.scalar("loss", sl, step)
                    tb.scalar("accuracy", sacc, step)
                    tb.scalar("learning_rate", float(sched(step)), step)
                    print(f"Iter {step}, Minibatch Loss= {sl:.4f}, Training Accuracy= {sacc:.4f}",
                          flush=True)
                total_loss += l.detach()
            print(f"Epoch {epoch}, Average loss: {float(total_loss) / training_iters:.4f}, "
                  f"learning rate: {float(sched(self.state.step)):.4f}", flush=True)
            store_prediction(test_x, test_y, f"epoch_{epoch}")
            self._save(output_path)
        tb.close()
        return save_path
