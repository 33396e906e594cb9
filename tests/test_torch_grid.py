"""The PyTorch port's Grid and Problem against the JAX package's: the same
fields bit for bit, the same error location, the same problem flags."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cubez_tpu import Problem as JProblem
from cubez_tpu.core.grid import max_error as j_max_error
from cubez_tpu.core.grid import max_error_loc as j_max_error_loc

import cubez_tpu_torch as czt

torch.set_num_threads(1)

SHAPES = [17, (10, 12, 14)]
DTYPES = ["float32", "float64"]


def _pair(n, dtype):
    jp = JProblem.poisson_cube(n, dtype=getattr(jnp, dtype))
    tp = czt.Problem.poisson_cube(n, dtype=getattr(torch, dtype), device="cpu")
    return jp, tp


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("n", SHAPES)
def test_fields_bitwise_equal(n, dtype):
    jp, tp = _pair(n, dtype)
    for name in ("bc_field", "exact", "inner_mask"):
        a = np.asarray(getattr(jp.grid, name))
        b = getattr(tp.grid, name).numpy()
        assert a.dtype == b.dtype, name
        np.testing.assert_array_equal(a, b, err_msg=name)
    np.testing.assert_array_equal(np.asarray(jp.x0), tp.x0.numpy())
    np.testing.assert_array_equal(np.asarray(jp.rhs), tp.rhs.numpy())
    for axis in "ijk":
        np.testing.assert_array_equal(
            np.asarray(jp.grid.coords(axis)), tp.grid.coords(axis).numpy()
        )


@pytest.mark.parametrize("n", SHAPES)
def test_grid_scalars_equal(n):
    jp, tp = _pair(n, "float32")
    for name in ("shape_kij", "pitch", "num_inner", "res_normal"):
        assert getattr(jp.grid, name) == getattr(tp.grid, name), name


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("n", SHAPES)
def test_max_error_loc_matches_jax(n, dtype):
    jp, tp = _pair(n, dtype)
    rng = np.random.default_rng(5)
    p = np.asarray(jp.grid.exact) + 1e-3 * rng.standard_normal(
        jp.grid.shape_kij
    ).astype(dtype)
    je, jloc = j_max_error_loc(jp.grid, jnp.asarray(p))
    te, tloc = czt.max_error_loc(tp.grid, torch.tensor(p))
    assert (te, tloc) == (je, jloc)
    assert czt.max_error(tp.grid, torch.tensor(p)) == j_max_error(
        jp.grid, jnp.asarray(p)
    )


def test_max_error_loc_first_of_ties_is_one_based():
    tp = czt.Problem.poisson_cube((6, 7, 8), device="cpu")
    p = tp.grid.exact.clone()
    p[3, 2, 4] += 1.0  # (k, i, j) -> 1-based (i j k) = (3 5 4)
    p[5, 4, 1] += 1.0  # same error later in memory order
    err, loc = czt.max_error_loc(tp.grid, p)
    assert loc == (3, 5, 4) and err == 1.0


def test_problem_flags():
    tp = czt.Problem.poisson_cube(12, device="cpu")
    assert tp.rhs_inner_zero and tp.rhs_is_inner_zero()
    assert tp.msk_is_standard()
    assert tp.x0 is not tp.grid.bc_field  # steps may update state in place
    rhs = tp.rhs.clone()
    rhs[5, 5, 5] = 1.0
    assert not dataclasses.replace(tp, rhs=rhs).rhs_is_inner_zero()
    msk = tp.msk.clone()
    assert dataclasses.replace(tp, msk=msk).msk_is_standard()
    msk[4, 4, 4] = 0.0
    assert not dataclasses.replace(tp, msk=msk).msk_is_standard()
    msk = tp.msk.clone()
    msk[0, 3, 3] = 1.0
    assert not dataclasses.replace(tp, msk=msk).msk_is_standard()


def test_poisson_cube_maf_names_slice_2():
    with pytest.raises(NotImplementedError, match="slice 2"):
        czt.Problem.poisson_cube(8, device="cpu", maf=True)


def test_from_arrays_copies_and_checks_shape():
    shape = (6, 8, 10)
    x0 = np.random.default_rng(1).standard_normal(shape).astype(np.float32)
    rhs = np.zeros(shape, np.float32)
    p = czt.Problem.from_arrays(shape, torch.float32, x0, rhs, device="cpu")
    assert p.grid.shape_kij == shape and p.msk_is_standard()
    p.x0.add_(1.0)
    assert x0[0, 0, 0] != p.x0[0, 0, 0]  # the caller's array is untouched
    with pytest.raises(ValueError, match="shape"):
        czt.Problem.from_arrays(shape, torch.float32, x0[:-1], rhs, device="cpu")
