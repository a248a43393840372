"""The training step's random regularizers: dropout masks and Graves
weight noise (the draws of the JAX package's train/loop.py :473-497).

JAX keys them by folding the step into `PRNGKey(seed ^ 0xD120)` (dropout)
and `PRNGKey(seed ^ 0x5EED)` (weight noise); the port seeds a
torch.Generator with the same integers (utils/seeds.py). Dropout masks are
drawn for the global batch and each rank keeps its rows, so that a row's
mask depends on its global index, not on the rank that trains it. Weight
noise is drawn leaf by leaf, each leaf's generator seeded with its path in
the params tree, so that the draws do not depend on the order in which a
tree is flattened (torch's pytree keeps a dict's insertion order, JAX
sorts its keys).
"""

from __future__ import annotations

import torch

from rnn_transducer_tpu_torch.utils.seeds import generator

DROPOUT_SALT = 0xD120
NOISE_SALT = 0x5EED


class DropoutMasks:
    """The keep masks of one step: `masks(site, x, keep)` -> bool of x's
    shape. x holds the rows offset .. offset + x.shape[0] of a global batch
    of `global_batch` rows; the mask of the whole batch is drawn (uniforms
    below `keep`, from a generator on x's device seeded with (seed ^
    0xD120, step, site)) and the rows of x taken from it."""

    def __init__(self, seed: int, step: int, offset: int = 0,
                 global_batch: int | None = None):
        self.seed, self.step = seed, step
        self.offset, self.global_batch = offset, global_batch

    def __call__(self, site: int, x: torch.Tensor, keep: float):
        B = x.shape[0]
        n = self.global_batch or B
        g = generator(self.seed ^ DROPOUT_SALT, self.step, site,
                      device=x.device)
        u = torch.rand((n, *x.shape[1:]), generator=g, device=x.device)
        return u[self.offset:self.offset + B] < keep


def leaf_paths(tree, path: str = ""):
    """'/'-joined dict keys and list indices of every leaf, in the order
    of torch's pytree flatten (dicts in insertion order)."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from leaf_paths(v, f"{path}/{k}")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from leaf_paths(v, f"{path}/{i}")
    else:
        yield path


def weight_noise(seed: int, step: int, paths, leaves) -> list:
    """Standard normal noise for every leaf, each from a generator on the
    leaf's device seeded with (seed ^ 0x5EED, step, its path)."""
    out = []
    for path, p in zip(paths, leaves):
        g = generator(seed ^ NOISE_SALT, step, path, device=p.device)
        out.append(torch.randn(p.shape, generator=g, dtype=p.dtype,
                               device=p.device))
    return out
