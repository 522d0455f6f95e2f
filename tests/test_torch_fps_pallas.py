"""The JAX package's pair-unrolled FPS kernel ``fps_pallas._fps_kernel``
(reached through ``furthest_point_sample_pallas(..., vectorized=False)``,
which only the profilers in ``tools/`` call) computes kernel A's function:
the port's plain FPS, the version ``chip_smoke.py`` holds kernel A to,
gives the same picks, index for index. The Pallas kernel runs in TPU
interpret mode on the CPU.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from epnet_tpu.ops import pointops as jpo
from epnet_tpu.ops.fps_pallas import furthest_point_sample_pallas
from epnet_tpu_torch.ops.fps import furthest_point_sample_plain
from epnet_tpu_torch.utils.testing import structured_scene


@pytest.fixture(autouse=True)
def residual_queries(monkeypatch):
    monkeypatch.setattr(jpo, 'EXACT_QUERIES', 'residual')  # module state


def _cloud(kind):
    rng = np.random.RandomState(0)
    if kind == 'structured':
        return structured_scene(rng, 1024)[0][None]
    if kind == 'ties':  # a coarse grid: many equal distances
        return rng.randint(0, 3, (2, 256, 3)).astype(np.float32)
    return rng.randn(3, 512, 3).astype(np.float32)  # batch 3: one cloud a grid step


@pytest.mark.parametrize('kind,npoint', [('random_b3', 64), ('structured', 256), ('ties', 27)])
def test_fps_kernel_picks_equal_kernel_a_function(kind, npoint):
    xyz = _cloud(kind)
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(furthest_point_sample_pallas(jnp.asarray(xyz), npoint, 0, False))
    got = furthest_point_sample_plain(torch.from_numpy(xyz), npoint)
    np.testing.assert_array_equal(got.numpy(), want)
    assert (want[:, 0] == 0).all()
