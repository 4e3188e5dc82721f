"""NeRF-style positional encoding as a pure jnp function.

Semantics match the reference embedder (`/root/reference/models/embedder.py:32-46`):
output layout is ``[x, sin(f0·x), cos(f0·x), sin(f1·x), cos(f1·x), ...]`` with
log-spaced frequencies ``f_k = 2^k, k = 0..multires-1`` and the identity block
first (the SDF geometric init relies on raw coordinates occupying the first
``input_dims`` channels, `fields.py:62-63`).

The encode is pure elementwise work that XLA fuses into the consuming
matmul's producer. Frequencies are baked as compile-time constants.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np


def embedder_out_dim(multires: int, input_dims: int = 3) -> int:
    if multires <= 0:
        return input_dims
    return input_dims * (1 + 2 * multires)


def make_embedder(multires: int, input_dims: int = 3):
    """Return ``(embed_fn, out_dim)``.

    ``embed_fn`` maps ``[..., input_dims] -> [..., out_dim]``.
    """
    if multires <= 0:
        return (lambda x: x), input_dims

    freqs = np.asarray(2.0 ** np.linspace(0.0, multires - 1, multires), dtype=np.float32)
    out_dim = embedder_out_dim(multires, input_dims)

    def embed(x: jnp.ndarray) -> jnp.ndarray:
        # [..., F, D] angles; interleave sin/cos per frequency to match the
        # reference layout [x, sin(f0 x), cos(f0 x), sin(f1 x), ...]
        ang = x[..., None, :] * freqs[:, None]            # [..., F, D]
        sc = jnp.stack([jnp.sin(ang), jnp.cos(ang)], axis=-2)  # [..., F, 2, D]
        sc = sc.reshape(*x.shape[:-1], 2 * len(freqs) * x.shape[-1])
        return jnp.concatenate([x, sc], axis=-1)

    return embed, out_dim
