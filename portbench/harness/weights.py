"""Random weights drawn on the device from the run's seed, shared by the
model kinds (``kinds/<kind>.py`` says which leaves each model has and at
what scale): every leaf of a tree is filled from one uniform and one normal
draw, in the dtype the model is served in.
"""

import math

import torch


class Draws:
    """Collects leaves, then fills them from one uniform and one normal draw."""

    def __init__(self):
        self.leaves = []  # (container, key, shape, kind, scale)

    def uniform(self, box, key, shape, bound):
        self.leaves.append((box, key, tuple(shape), "u", bound))

    def normal(self, box, key, shape, std):
        self.leaves.append((box, key, tuple(shape), "n", std))

    def fill(self, gen, device, dtype):
        sizes = {"u": 0, "n": 0}
        for _, _, shape, kind, _ in self.leaves:
            sizes[kind] += math.prod(shape)
        pools = {
            "u": torch.rand(sizes["u"], generator=gen, device=device) * 2.0 - 1.0,
            "n": torch.randn(sizes["n"], generator=gen, device=device),
        }
        offsets = {"u": 0, "n": 0}
        for box, key, shape, kind, scale in self.leaves:
            n = math.prod(shape)
            box[key] = (pools[kind][offsets[kind] : offsets[kind] + n].reshape(shape)
                        * scale).to(dtype)
            offsets[kind] += n


def rotations(gen, n, c, device):
    """n random rotations [n, c, c] (QR of a normal matrix, det +1) and their
    inverses, computed in float64."""
    a = torch.randn((n, c, c), generator=gen, device=device).double()
    q, _ = torch.linalg.qr(a)
    flip = torch.linalg.det(q) < 0
    q[flip, :, 0] *= -1
    return q.float(), torch.linalg.inv(q).float()


def to_dtype(tree, dtype):
    """The tree with its floating tensors in ``dtype``."""
    if isinstance(tree, dict):
        return {k: to_dtype(v, dtype) for k, v in tree.items()}
    if isinstance(tree, list):
        return [to_dtype(v, dtype) for v in tree]
    return tree.to(dtype) if tree.is_floating_point() else tree
