"""mmvqa_tpu_torch.data.images against the JAX package, on the CPU.

JAX's random bits cannot be reproduced in PyTorch, so the draws the JAX
package makes from its key (crop boxes, jitter factors) are worked out here
with its own key splitting and handed to the port's ``apply_augment``: both
packages then apply the same draws to the same images.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from mmvqa_tpu.data import images as jax_images

from mmvqa_tpu_torch.data import images

# tier-1 runs six test workers on eight cores: one torch thread each
torch.set_num_threads(1)

S, B = 24, 3


def _jax_draws(key, n, size, spec):
    """The (crop, jitter) draws ``jax_images.process_batch`` makes from
    ``key``: its key tree, its ``_sample_crop``, and the uniform draws of
    ``_color_jitter``."""
    keys = jax.random.split(key, n * 2).reshape(n, 2, 2)
    crop, jitter = [], []
    for i in range(n):
        crop.append([float(v) for v in
                     jax_images._sample_crop(keys[i, 0], size, spec)])
        kb, kc, ks, kh = jax.random.split(keys[i, 1], 4)
        row = []
        for k, amount in ((kb, spec.brightness), (kc, spec.contrast),
                          (ks, spec.saturation)):
            row.append(float(jax.random.uniform(
                k, (), minval=1 - amount, maxval=1 + amount)))
        row.append(float(jax.random.uniform(kh, (), minval=-spec.hue,
                                            maxval=spec.hue)))
        jitter.append(row)
    return images.AugmentDraws(torch.tensor(crop), torch.tensor(jitter))


SPECS = {"pretrain": ("PRETRAIN_AUG", {}), "finetune": ("FINETUNE_AUG", {}),
         "crop_only": ("PRETRAIN_AUG", dict(brightness=0.0, contrast=0.0,
                                            saturation=0.0, hue=0.0))}


@pytest.mark.parametrize("name", sorted(SPECS))
def test_augment_with_the_jax_packages_draws_matches_jax(rng, name):
    import dataclasses

    attr, over = SPECS[name]
    jspec = dataclasses.replace(getattr(jax_images, attr), **over)
    spec = dataclasses.replace(getattr(images, attr), **over)
    assert dataclasses.asdict(jspec) == dataclasses.asdict(spec)
    u8 = rng.integers(0, 256, size=(B, S, S, 3), dtype=np.uint8)
    key = jax.random.PRNGKey(5)
    want = np.asarray(jax_images.process_batch(jnp.asarray(u8), key, jspec,
                                               True))
    got = images.process_batch(torch.from_numpy(u8), None, spec, True,
                               draws=_jax_draws(key, B, S, jspec))
    assert got.shape == want.shape and got.dtype == torch.float32
    # two interpolation products and the jitter arithmetic in fp32
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=2e-5)
    assert np.abs(want - ((u8 / 255.0 - 0.5) / 0.5)).max() > 1e-2


def test_without_augment_it_only_normalises(rng):
    u8 = rng.integers(0, 256, size=(B, S, S, 3), dtype=np.uint8)
    want = np.asarray(jax_images.process_batch(
        jnp.asarray(u8), jax.random.PRNGKey(0), jax_images.PRETRAIN_AUG, False))
    got = images.process_batch(torch.from_numpy(u8))
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-6)


@pytest.mark.parametrize("name", ["PRETRAIN_AUG", "FINETUNE_AUG"])
def test_sampled_draws_lie_in_the_specs_ranges(name):
    spec = getattr(images, name)
    n, size = 4000, 224
    d = images.sample_draws(n, size, torch.Generator().manual_seed(0), spec)
    y0, x0, h, w = d.crop.unbind(1)
    area, ratio = h * w / size**2, w / h
    assert (h <= size).all() and (w <= size).all()
    assert (y0 >= 0).all() and (y0 + h <= size + 1e-3).all()
    assert (x0 >= 0).all() and (x0 + w <= size + 1e-3).all()
    free = (h < size) & (w < size)  # boxes the clamp did not touch
    assert free.any()
    assert area[free].min() >= spec.crop_scale[0] - 1e-4
    assert area[free].max() <= spec.crop_scale[1] + 1e-4
    assert ratio[free].min() >= spec.crop_ratio[0] - 1e-4
    assert ratio[free].max() <= spec.crop_ratio[1] + 1e-4
    for col, amount in enumerate((spec.brightness, spec.contrast,
                                  spec.saturation)):
        f = d.jitter[:, col]
        assert 1 - amount <= f.min() and f.max() <= 1 + amount
        assert f.max() - f.min() > amount  # the range is used
    assert d.jitter[:, 3].abs().max() <= spec.hue


def test_one_seed_gives_one_set_of_draws_and_augment_needs_a_source(rng):
    a = images.sample_draws(5, S, torch.Generator().manual_seed(3))
    b = images.sample_draws(5, S, torch.Generator().manual_seed(3))
    c = images.sample_draws(5, S, torch.Generator().manual_seed(4))
    assert torch.equal(a.crop, b.crop) and torch.equal(a.jitter, b.jitter)
    assert not torch.equal(a.crop, c.crop)
    u8 = torch.zeros(1, S, S, 3, dtype=torch.uint8)
    with pytest.raises(ValueError, match="generator or draws"):
        images.process_batch(u8, augment=True)
