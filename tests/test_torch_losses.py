"""PyTorch port: the clustered-prototype loss against the JAX one.

Inputs from numpy seeds at the tiny config's phase-2 sizes: a teacher
latent of 16x16x8 (C 8) and students of 12x12x8 and 8x8x8 cut from it,
with the coordinate grids the pretrain transform gives (the teacher's
centred grid, each student's a crop of it).  The JAX loss draws each
student's jitter from its key; the test draws the same jitters with
``jax.random`` and passes them to the port.  Each part and the whole
loss agree to 1e-5 relative (fp32, the same formulas); the nearest-point
indices and masks exactly; the gradient into the student embeddings to
1e-4 of its largest magnitude.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from medical_image_segmentation_with_visual_prompts_tpu.losses import \
    clustered_prototype as jcp
from medical_image_segmentation_with_visual_prompts_tpu_torch.losses import \
    clustered_prototype as pcp

RF = 2.0
FWHM = 16.0


def _coord_grid(shape):
    h, w, d = shape
    grid = np.stack(np.meshgrid(np.arange(h), np.arange(w), np.arange(d),
                                indexing="ij"), -1).astype(np.float32)
    return grid - np.array([(h - 1) / 2, (w - 1) / 2, (d - 1) / 2],
                           np.float32)


def _inputs(seed=0, b=2, c=8):
    rng = np.random.default_rng(seed)
    emb_t = rng.standard_normal((b, 16, 16, 8, c)).astype(np.float32)
    coord_t = np.broadcast_to(_coord_grid((16, 16, 8)),
                              (b, 16, 16, 8, 3)).copy()
    emb_s, coord_s = [], []
    for size in ((12, 12, 8), (8, 8, 8)):
        starts = [rng.integers(0, 16 - size[0] + 1, b),
                  rng.integers(0, 16 - size[1] + 1, b)]
        e = rng.standard_normal((b, *size, c)).astype(np.float32)
        cs = np.stack([coord_t[k, starts[0][k]:starts[0][k] + size[0],
                               starts[1][k]:starts[1][k] + size[1]]
                       for k in range(b)])
        emb_s.append(e)
        coord_s.append(np.ascontiguousarray(cs))
    return emb_s, emb_t, coord_s, coord_t


def _jax_jitters(key, n):
    high = max(int(np.ceil(RF)), 1)
    return [np.asarray(jax.random.randint(jax.random.fold_in(key, i), (6,),
                                          0, high)).tolist()
            for i in range(n)]


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


def _close(got, want, rtol=1e-5):
    want = np.asarray(want)
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=rtol,
                               atol=rtol * max(float(np.abs(want).max()),
                                               1e-30))


@pytest.mark.parametrize("jitter", [None, [0, 1, 1, 0, 1, 1], [1, 1, 0, 0,
                                                              0, 1]])
def test_sample_embedding_matches_jax(jitter):
    emb_s, _, coord_s, _ = _inputs()
    for e, c in zip(emb_s, coord_s):
        je, jc = jcp.sample_embedding(
            jnp.asarray(e), jnp.asarray(c), RF,
            None if jitter is None else jnp.asarray(jitter, jnp.int32))
        pe, pc = pcp.sample_embedding(_t(e), _t(c), RF, jitter)
        _close(pe, je)
        _close(pc, jc)


def test_parts_match_jax():
    emb_s, emb_t, coord_s, coord_t = _inputs(1)
    # The second student's second sample moved 6 voxels along H: its
    # points past the teacher's edge are out of reach.
    coord_s[1][1, ..., 0] += 6.0
    jp0 = jcp.sample_embedding(jnp.asarray(emb_t), jnp.asarray(coord_t),
                               2 * RF)
    jts = jcp.sample_embedding(jnp.asarray(emb_t), jnp.asarray(coord_t), RF)
    pp0 = pcp.sample_embedding(_t(emb_t), _t(coord_t), 2 * RF)
    pts = pcp.sample_embedding(_t(emb_t), _t(coord_t), RF)
    _close(pcp._pos_weights(pts[1], pp0[1], FWHM),
           jcp._pos_weights(jts[1], jp0[1], FWHM))
    jproto = jcp.cluster_prototype(*jp0, *jts, 2, 0.033, FWHM)
    pproto = pcp.cluster_prototype(*pp0, *pts, 2, 0.033, FWHM)
    for a, b in zip(pproto, jproto):
        _close(a, b)
    for i, (e, c) in enumerate(zip(emb_s, coord_s)):
        jz = jcp.sample_embedding(jnp.asarray(e), jnp.asarray(c), RF,
                                  jnp.asarray([1, 0, 0, 1, 1, 0], jnp.int32))
        pz = pcp.sample_embedding(_t(e), _t(c), RF, [1, 0, 0, 1, 1, 0])
        jidx, jmask = jcp._closest(jz[1], jts[1])
        pidx, pmask = pcp._closest(pz[1], pts[1])
        np.testing.assert_array_equal(pidx.numpy(), np.asarray(jidx))
        np.testing.assert_array_equal(pmask.numpy(), np.asarray(jmask))
        assert pmask.any() and pmask.all() == (i == 0)
        _close(pcp.assign_prototype(*pz, *pts, pproto[0], pproto[2], 0.066),
               jcp.assign_prototype(*jz, *jts, jproto[0], jproto[2], 0.066))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_loss_and_student_gradient_match_jax(seed):
    emb_s, emb_t, coord_s, coord_t = _inputs(seed)
    key = jax.random.PRNGKey(seed + 10)
    jitters = _jax_jitters(key, len(emb_s))
    kw = dict(reduction_factor=RF, k_means_iterations=2, fwhm=FWHM)

    def jloss(es):
        return jcp.clustered_prototype_loss(
            es, jnp.asarray(emb_t), [jnp.asarray(c) for c in coord_s],
            jnp.asarray(coord_t), key, **kw)

    jes = [jnp.asarray(e) for e in emb_s]
    want, jgrads = jax.value_and_grad(jloss)(jes)
    pes = [_t(e).requires_grad_(True) for e in emb_s]
    got = pcp.clustered_prototype_loss(
        pes, _t(emb_t), [_t(c) for c in coord_s], _t(coord_t), jitters, **kw)
    np.testing.assert_allclose(got.item(), float(want), rtol=1e-5)
    got.backward()
    for p, g in zip(pes, jgrads):
        g = np.asarray(g)
        scale = float(np.abs(g).max())
        assert scale > 0
        assert np.abs(p.grad.numpy() - g).max() <= 1e-4 * scale


def test_no_point_in_reach_gives_zero_not_nan():
    """A student far from every teacher point: the masked mean is 0 and
    its gradient finite, in both packages."""
    emb_s, emb_t, coord_s, coord_t = _inputs(3)
    far = [c + 1000.0 for c in coord_s]
    key = jax.random.PRNGKey(5)
    kw = dict(reduction_factor=RF, k_means_iterations=2, fwhm=FWHM)
    want = jcp.clustered_prototype_loss(
        [jnp.asarray(e) for e in emb_s], jnp.asarray(emb_t),
        [jnp.asarray(c) for c in far], jnp.asarray(coord_t), key, **kw)
    pes = [_t(e).requires_grad_(True) for e in emb_s]
    got = pcp.clustered_prototype_loss(
        pes, _t(emb_t), [_t(c) for c in far], _t(coord_t),
        _jax_jitters(key, 2), **kw)
    assert float(want) == 0.0 and got.item() == 0.0
    got.backward()
    assert all(torch.isfinite(p.grad).all() for p in pes)


def test_draw_jitters_range_and_seed():
    g = torch.Generator().manual_seed(0)
    js = pcp.draw_jitters(3, 2.5, g)
    assert len(js) == 3 and all(len(j) == 6 for j in js)
    assert {v for j in js for v in j} <= {0, 1, 2}
    assert js == pcp.draw_jitters(3, 2.5, torch.Generator().manual_seed(0))
    with pytest.raises(ValueError):
        pcp.clustered_prototype_loss([torch.zeros(1, 4, 4, 4, 2)],
                                     torch.zeros(1, 4, 4, 4, 2),
                                     [torch.zeros(1, 4, 4, 4, 3)],
                                     torch.zeros(1, 4, 4, 4, 3), [])
