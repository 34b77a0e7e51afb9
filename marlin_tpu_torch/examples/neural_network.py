"""NeuralNetwork: mini-batch SGD for a 1-hidden-layer sigmoid MLP, the
port's counterpart of ``marlin_tpu/examples/neural_network.py``
(``examples/NeuralNetwork.scala``:33-290).

Laid out as the JAX example: the dataset is row-sharded over the mesh
(the reference's partition-aligned blocks; each rank holds its row
stripe of the images and labels and no rank gathers them whole) and the
weights are replicated. The reference's on-device mini-batch gather plus
psum becomes: the whole ``(iterations, batch_size)`` index table drawn
once from a seeded CPU generator (so a run on the card and one on the CPU
take the same batches); at each step each rank takes the sampled rows it
holds, computes its part of the gradient with autograd, one
``all_reduce`` sums the parts (and the loss), and every rank applies the
same SGD update. The forward, loss and initialisation have the JAX
example's names and math.

Usage:
  python -m marlin_tpu_torch.examples.neural_network --synthetic 4096 \\
      [--batch-size 512] [--iterations 50] [--hidden 256] [--output w_dir] \\
      [--device cuda|cpu]
  python -m marlin_tpu_torch.examples.neural_network --images mnist.csv ...
"""

from __future__ import annotations

import argparse
import json
import os
import time
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from ..config import matmul_precision_scope
from ..matrix import DenseVecMatrix
from ..mesh import (Mesh, all_reduce_sum, create_mesh, default_mesh,
                    local_slices)
from ..utils.random import hash_seed

Params = Dict[str, torch.Tensor]


def forward(params: Params, x: torch.Tensor) -> torch.Tensor:
    """block @ hiddenWeight -> sigmoid -> @ outputWeight -> sigmoid
    (NeuralNetwork.scala:223-232)."""
    h = torch.sigmoid(x @ params["hidden"])
    return torch.sigmoid(h @ params["output"])


def loss_fn(params: Params, x: torch.Tensor, y: torch.Tensor
            ) -> torch.Tensor:
    """Squared error, as in computeOutputError
    (NeuralNetwork.scala:120-134)."""
    pred = forward(params, x)
    return 0.5 * torch.mean(torch.sum((pred - y) ** 2, dim=1))


def init_params(d_in: int, d_hidden: int, d_out: int, seed=0,
                dtype=torch.float32, device="cuda") -> Params:
    """Normal weights scaled by 1 / sqrt(fan_in), drawn from a CPU
    ``torch.Generator`` seeded with ``hash_seed(seed)`` (the same values
    on every device), then placed on ``device``."""
    gen = torch.Generator().manual_seed(hash_seed(seed))
    hidden = torch.randn((d_in, d_hidden), generator=gen, dtype=dtype)
    output = torch.randn((d_hidden, d_out), generator=gen, dtype=dtype)
    return {"hidden": (hidden / np.sqrt(d_in)).to(device),
            "output": (output / np.sqrt(d_hidden)).to(device)}


def params_from_jax(params, device="cuda") -> Params:
    """The JAX example's params (a dict of arrays, e.g. numpy) as the
    port's, in float32 on ``device``."""
    return {name: torch.as_tensor(np.asarray(w, np.float32)).to(device)
            for name, w in params.items()}


def batch_indices(n: int, batch_size: int, iterations: int,
                  seed=0) -> torch.Tensor:
    """The (iterations, batch_size) table of sampled row indices (the
    genRandomBlocks sampling, :94), drawn once from a CPU generator seeded
    with ``hash_seed(seed) + 1``."""
    gen = torch.Generator().manual_seed(hash_seed(seed) + 1)
    return torch.randint(0, n, (iterations, batch_size), generator=gen)


def _stripe(arr: np.ndarray, mesh: Mesh):
    """(this rank's row stripe of ``arr`` as float32 on the mesh's device,
    the stripe's first row)."""
    mat = DenseVecMatrix(np.asarray(arr, np.float32), mesh=mesh)
    rows = local_slices(mat._sharding(), mat._physical_shape)[0]
    return mat.local, rows.start


def train_with_losses(images: np.ndarray, labels: np.ndarray,
                      hidden: int = 256, batch_size: int = 512,
                      iterations: int = 50, learning_rate: float = 0.5,
                      seed: int = 0, mesh: Optional[Mesh] = None):
    """:func:`train`, returning (params, the loss of every step, a
    float32 tensor on the mesh's device); (None, None) on a rank outside
    the mesh. Collective over the mesh."""
    mesh = mesh or default_mesh()
    if not mesh.holds:
        return None, None
    n, d_in = images.shape
    d_out = labels.shape[1]
    x_local, first = _stripe(images, mesh)
    y_local, _ = _stripe(labels, mesh)
    device = x_local.device
    params = init_params(d_in, hidden, d_out, seed=seed, device=device)
    table = batch_indices(n, batch_size, iterations, seed).to(device)
    rows = x_local.shape[0]
    losses = []
    for i in range(iterations):
        # The sampled rows this rank holds, each weighted 1 (a row sampled
        # twice counts twice); the others read row 0 and weigh 0.
        at = table[i] - first
        mine = (at >= 0) & (at < rows)
        at = torch.where(mine, at, torch.zeros_like(at))
        x, y, w = x_local[at], y_local[at], mine.to(x_local.dtype)
        leaves = {k: v.requires_grad_() for k, v in params.items()}
        with matmul_precision_scope():
            pred = forward(leaves, x)
            part = 0.5 * torch.sum(w * torch.sum((pred - y) ** 2, dim=1)) \
                / batch_size
            grads = torch.autograd.grad(part, list(leaves.values()))
        # One all-reduce sums the loss and every gradient over the mesh.
        flat = all_reduce_sum(torch.cat(
            [part.detach().reshape(1)] + [g.reshape(-1) for g in grads]),
            mesh)
        losses.append(flat[0])
        off = 1
        for name, p in leaves.items():
            g = flat[off:off + p.numel()].view_as(p)
            off += p.numel()
            params[name] = p.detach() - learning_rate * g
    return params, torch.stack(losses)


def train(images: np.ndarray, labels: np.ndarray, hidden: int = 256,
          batch_size: int = 512, iterations: int = 50,
          learning_rate: float = 0.5, seed: int = 0,
          mesh: Optional[Mesh] = None) -> Tuple[Params, float]:
    """Mini-batch SGD; returns (params, final mini-batch loss). The data
    row-sharded over ``mesh`` (default: the default mesh), the weights
    replicated. Collective over the mesh."""
    params, losses = train_with_losses(images, labels, hidden, batch_size,
                                       iterations, learning_rate, seed,
                                       mesh)
    return params, None if losses is None else float(losses[-1])


def save_weights_csv(params: Params, out_dir: str) -> None:
    """CSV export like the reference's csvwrite
    (NeuralNetwork.scala:260-261)."""
    os.makedirs(out_dir, exist_ok=True)
    for name, w in params.items():
        np.savetxt(os.path.join(out_dir, f"{name}.csv"),
                   w.detach().cpu().numpy(), delimiter=",")


def load_mnist_csv(path: str, d_in: int = 784, d_out: int = 10):
    """Rows: label,pix,pix,... (the loadMNISTImages analogue, :33-85)."""
    raw = np.loadtxt(path, delimiter=",")
    labels = np.eye(d_out)[raw[:, 0].astype(int)]
    images = raw[:, 1:] / 255.0
    return images, labels


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--images", help="MNIST csv: label,pix,...")
    p.add_argument("--synthetic", type=int, metavar="N",
                   help="N synthetic samples")
    p.add_argument("--d-in", type=int, default=784)
    p.add_argument("--d-out", type=int, default=10)
    p.add_argument("--hidden", type=int, default=256)
    p.add_argument("--batch-size", type=int, default=512)
    p.add_argument("--iterations", type=int, default=50)
    p.add_argument("--learning-rate", type=float, default=0.5)
    p.add_argument("--output", help="directory for weight CSVs")
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)

    if args.images:
        images, labels = load_mnist_csv(args.images, args.d_in, args.d_out)
    elif args.synthetic:
        rng = np.random.default_rng(0)
        images = rng.random((args.synthetic, args.d_in))
        classes = rng.integers(0, args.d_out, args.synthetic)
        labels = np.eye(args.d_out)[classes]
    else:
        p.error("give --images or --synthetic N")

    mesh = create_mesh(device=args.device)
    t0 = time.perf_counter()
    params, loss = train(images, labels, hidden=args.hidden,
                         batch_size=args.batch_size,
                         iterations=args.iterations,
                         learning_rate=args.learning_rate, mesh=mesh)
    dt = time.perf_counter() - t0
    if args.output:
        save_weights_csv(params, args.output)
    print(json.dumps({"example": "NeuralNetwork",
                      "samples": int(images.shape[0]),
                      "hidden": args.hidden,
                      "iterations": args.iterations,
                      "final_loss": round(loss, 6),
                      "seconds": round(dt, 6),
                      **({"output": args.output} if args.output else {})}))
    return params


if __name__ == "__main__":
    main()
