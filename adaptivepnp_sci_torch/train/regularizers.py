"""SVD orthogonalization regularizer of FFDNet training
(port of ``adaptivepnp_sci_tpu.train.regularizers``).

The reference's ``svd_orthogonalization`` (``packages/ffdnet/utils.py:
269-301``) replaces every conv filter bank, viewed as a ``(kh*kw*cin, cout)``
matrix, by the nearest matrix with orthonormal columns, ``U @ Vh``. The JAX
package reshapes its Flax kernel ``(kh, kw, cin, cout)``; a torch weight
``(cout, cin, kh, kw)`` reshaped to ``(cout, cin*kh*kw)`` and transposed is
the same matrix with its rows permuted, and the polar factor commutes with a
row permutation, so both layouts give the same weights.
"""

from __future__ import annotations

import torch
import torch.nn as nn
from torch import Tensor


def orthogonalize_kernel(w: Tensor) -> Tensor:
    """The polar factor of a 4-D conv weight ``(cout, cin/groups, kh, kw)``
    as a ``(cin/groups*kh*kw, cout)`` matrix, in the weight's layout; any
    other tensor (biases, BatchNorm, DDnet's 5-D mixing weights) unchanged."""
    if w.dim() != 4:
        return w
    mat = w.reshape(w.shape[0], -1).transpose(0, 1)
    u, _, vh = torch.linalg.svd(mat, full_matrices=False)
    return (u @ vh).transpose(0, 1).reshape(w.shape).to(w.dtype)


@torch.no_grad()
def svd_orthogonalize(module: nn.Module) -> None:
    """Orthogonalize every 4-D weight (every conv kernel) of ``module`` in
    place, on the weight's own device."""
    for p in module.parameters():
        if p.dim() == 4:
            p.copy_(orthogonalize_kernel(p))
