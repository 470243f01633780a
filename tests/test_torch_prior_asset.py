"""The repo's pretrained prior carried across: the npz asset equals
``load_prior("artifacts/local_prior")`` array for array, and
``params_from_numpy`` / ``load_prior_npz`` make it the port's frozen prior.

The asset was written once from the orbax checkpoint (the command is in
CHANGES.md); this test holds it to the checkpoint.
"""

import _torch_threads  # noqa: F401  (caps torch's threads under xdist)

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spurfies_tpu.model.networks import mlp_apply as j_mlp_apply
from spurfies_tpu.prior.pretrain import load_prior
from spurfies_tpu_torch.convert.from_jax import (
    PRIOR_ASSET,
    load_prior_npz,
    params_from_numpy,
    params_to_numpy,
)
from spurfies_tpu_torch.model.networks import mlp_apply
from spurfies_tpu_torch.ops.pair_mlp import _prep_layers

CKPT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..",
                    "artifacts", "local_prior")


@pytest.fixture(scope="module")
def prior():
    return jax.tree_util.tree_map(np.asarray,
                                  load_prior(os.path.abspath(CKPT)))


def test_asset_equals_checkpoint(prior):
    with np.load(PRIOR_ASSET) as z:
        arrs = {k: z[k] for k in z.files}
    expect = {f"{name}.{i}.{key}": layer[key]
              for name in ("F_geometry", "T")
              for i, layer in enumerate(prior[name]) for key in ("w", "b")}
    assert sorted(arrs) == sorted(expect)
    for k, v in expect.items():
        assert arrs[k].dtype == np.float32
        np.testing.assert_array_equal(arrs[k], v)


def test_asset_loads_as_the_ports_frozen_prior(prior):
    frozen = load_prior_npz(device="cpu")
    assert len(frozen["F_geometry"]) == 5 and len(frozen["T"]) == 1
    assert tuple(frozen["F_geometry"][0]["w"].shape) == (35, 256)
    via_tree = params_from_numpy(prior, device="cpu")
    for name in ("F_geometry", "T"):
        for a, b in zip(frozen[name], via_tree[name]):
            for key in ("w", "b"):
                assert torch.equal(a[key], b[key])
    prep = _prep_layers(frozen, torch.bfloat16)
    assert prep.n_act == 4 and prep.ws[-1].shape == (256, 1)


def test_params_round_trip_and_same_mlp(prior):
    back = params_to_numpy(params_from_numpy(prior, device="cpu"))
    for name in ("F_geometry", "T"):
        for a, b in zip(back[name], prior[name]):
            for key in ("w", "b"):
                np.testing.assert_array_equal(a[key], b[key])
    x = np.random.default_rng(0).normal(0, 0.2, (256, 35)).astype(np.float32)
    ref = j_mlp_apply(jax.tree_util.tree_map(jnp.asarray,
                                             prior["F_geometry"]),
                      jnp.asarray(x))
    got = mlp_apply(params_from_numpy(prior, device="cpu")["F_geometry"],
                    torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-5,
                               atol=1e-5)
