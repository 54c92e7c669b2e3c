"""K7's plain version and the voxel masks in the port, against the JAX
package on the CPU: ``masked_flash_attention`` (the Pallas kernel in
interpret mode), ``voxel_grid_mask`` and ``voxel_positions``.

Inputs are drawn with numpy from fixed seeds. Both sides compute the same
f32 attention with its sums in another order: 1e-5 of the largest output.
The mask bits agree exactly at these inputs (no pair sits on the radius).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from motion324_tpu.hy3dgen import voxel_attention as jva
from motion324_tpu.ops.masked_attention import masked_flash_attention as jmask
from motion324_tpu_torch.hy3dgen import voxel_attention as tva
from motion324_tpu_torch.ops import masked_attention as tma

REL = 1e-5


def _qkv(seed, b, h, s):
    rng = np.random.RandomState(seed)
    return [rng.randn(b, h, s, 64).astype(np.float32) for _ in range(3)]


def _positions(seed, b, s, g):
    """Cell means on a g-lattice (many pairs within the radius 1.73/g), a
    run of empty cells at 0."""
    rng = np.random.RandomState(seed)
    pos = (rng.randint(0, g, (b, s, 3)) + rng.uniform(0.2, 0.8, (b, s, 3))) / g
    pos[:, : s // 8] = 0.0
    return pos.astype(np.float32)


@pytest.mark.parametrize("b,h,s,g", [(2, 3, 300, 4), (1, 2, 130, 3),
                                     (1, 1, 96, 2)])
def test_plain_matches_pallas_interpret(b, h, s, g):
    """S not a multiple of 128 (the Pallas kernel pads the queries with rows
    at 1e6 and masks padded keys by index), empty cells at 0."""
    q, k, v = _qkv(s, b, h, s)
    pos = _positions(s + 1, b, s, g)
    r = 1.73 / g
    want = np.asarray(jmask(*(jnp.asarray(x) for x in (q, k, v, pos)),
                            radius=r, block_q=128, block_kv=128,
                            interpret=True))
    got = tma.masked_flash_attention(*(torch.from_numpy(x) for x in (q, k, v, pos)),
                                     radius=r).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=REL * np.abs(want).max())


def test_keep_is_the_dense_mask():
    pos = _positions(5, 2, 200, 4)
    keep = tma.voxel_keep(torch.from_numpy(pos), torch.from_numpy(pos), 1.73 / 4)
    dense = np.linalg.norm(pos[:, :, None] - pos[:, None], axis=-1) < 1.73 / 4
    np.testing.assert_array_equal(keep.numpy(), dense)
    assert 0.02 < dense.mean() < 0.9
    assert keep.numpy()[:, np.arange(200), np.arange(200)].all()


def test_plain_equals_dense_mask_softmax():
    """The plain version is softmax attention with the dense mask."""
    q, k, v = _qkv(7, 1, 2, 150)
    pos = _positions(8, 1, 150, 3)
    r = 1.73 / 3
    dense = np.linalg.norm(pos[:, :, None] - pos[:, None], axis=-1) < r
    logits = np.einsum("bhqd,bhkd->bhqk", q, k) / 8.0
    logits = np.where(dense[:, None], logits, -np.inf)
    w = np.exp(logits - logits.max(-1, keepdims=True))
    want = np.einsum("bhqk,bhkd->bhqd", w / w.sum(-1, keepdims=True), v)
    got = tma.masked_flash_attention(*(torch.from_numpy(x) for x in (q, k, v, pos)),
                                     radius=r).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=REL * np.abs(want).max())


def _position_maps(seed, n=3, hw=16):
    rng = np.random.RandomState(seed)
    pm = rng.uniform(0, 0.999, (1, n, hw, hw, 3)).astype(np.float32)
    pm[..., : hw // 3, :, :] = 1.0          # background rows
    pm[0, 0, 5:9, 5:9] = 1.0                # a cell with under 5 valid pixels
    pm[0, 0, 4, 4] = 0.3
    return pm


@pytest.mark.parametrize("g", [8, 4, 2])
def test_voxel_masks_match(g):
    pm = _position_maps(g)
    want = np.asarray(jva.voxel_grid_mask(jnp.asarray(pm), g))
    got = tva.voxel_grid_mask(torch.from_numpy(pm), g).numpy()
    np.testing.assert_array_equal(got, want)
    jp, jr = jva.voxel_positions(jnp.asarray(pm), g)
    tp, tr = tva.voxel_positions(torch.from_numpy(pm), g)
    # the cell sums in another order: a few ulps
    np.testing.assert_allclose(tp.numpy(), np.asarray(jp), rtol=0, atol=1e-6)
    assert tr == jr == 1.73 / g


def test_cell_means_zero_low_support_cells_and_background():
    pm = _position_maps(1)
    mean, count = tva._cell_means(torch.from_numpy(pm), 4)
    jmean, jcount = jva._cell_means(jnp.asarray(pm), 4)
    np.testing.assert_array_equal(count.numpy(), np.asarray(jcount))
    np.testing.assert_allclose(mean.numpy(), np.asarray(jmean), rtol=0,
                               atol=1e-6)   # a few ulps, as above
    low = count.numpy()[..., 0] < 5
    assert low.any() and (mean.numpy()[low] == 0).all()


def test_multi_resolution_keys_by_joint_token_count():
    pm = _position_maps(2, n=2, hw=16)
    dense = tva.multi_resolution_mask(torch.from_numpy(pm), (8, 4))
    implicit = tva.multi_resolution_positions(torch.from_numpy(pm), (8, 4))
    assert sorted(dense) == sorted(implicit) == [32, 128]
    for n, m in implicit.items():
        keep = tma.voxel_keep(m.positions, m.positions, m.radius)
        assert (keep.numpy() == dense[n].numpy()).mean() > 0.999


def test_cpu_wrapper_runs_the_plain_version():
    q, k, v = (torch.from_numpy(x) for x in _qkv(0, 1, 1, 40))
    pos = torch.from_numpy(_positions(0, 1, 40, 2))
    before = tma.masked_flash_attention.launches
    out = tma.masked_flash_attention(q, k, v, pos, radius=0.9)
    assert tma.masked_flash_attention.launches == before
    assert torch.equal(out, tma.masked_attention_reference(q, k, v, pos,
                                                           radius=0.9))
