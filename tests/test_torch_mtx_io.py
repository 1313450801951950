"""Matrix Market I/O of the PyTorch port (io/mm.py) against the JAX
package's reader and writer: coordinate real, integer, complex and pattern
files in general, symmetric, hermitian and skew-symmetric storage, array
files, gzip, the reader fed the file's text, write/read round trips and the
bad-header status.

The files are written here from numpy data made from a seed. Values are
parsed, not computed: they must be equal; a round trip through
write_mtx's 17 significant digits is exact for float64.
"""

import gzip

import numpy as np
import pytest
import scipy.io
import scipy.sparse as sp
import torch

import aoclsparse_tpu_torch as tt
from aoclsparse_tpu_torch.io import read_mtx, read_mtx_arrays, write_mtx


@pytest.fixture(scope="module")
def ast():
    jax = pytest.importorskip("jax")
    jax.config.update("jax_enable_x64", True)
    import aoclsparse_tpu
    from aoclsparse_tpu.io import mm

    return aoclsparse_tpu, mm


def _coordinate(path, field, sym, seed=0, m=23, n=23):
    rng = np.random.default_rng(seed)
    S = sp.random(m, n, density=0.2, random_state=rng, format="coo")
    r, c = S.row, S.col
    if sym != "general":
        keep = r >= c if sym != "skew-symmetric" else r > c
        r, c = r[keep], c[keep]
    lines = [f"%%MatrixMarket matrix coordinate {field} {sym}", "% a comment line", f"{m} {n} {r.size}"]
    for i, j in zip(r, c):
        if field == "pattern":
            lines.append(f"{i + 1} {j + 1}")
        elif field == "complex":
            lines.append(f"{i + 1} {j + 1} {rng.standard_normal():.17g} {rng.standard_normal():.17g}")
        elif field == "integer":
            lines.append(f"{i + 1} {j + 1} {int(rng.integers(-9, 10))}")
        else:
            lines.append(f"{i + 1} {j + 1} {rng.standard_normal():.17g}")
    text = "\n".join(lines) + "\n"
    path.write_text(text)
    return text


def _eq_arrays(got, want):
    assert tuple(got[:2]) == tuple(want[:2])
    for g, w in zip(got[2:], want[2:]):
        np.testing.assert_array_equal(np.asarray(g), np.asarray(w))


CASES = [("real", "general"), ("real", "symmetric"), ("real", "skew-symmetric"), ("integer", "general"),
         ("complex", "general"), ("complex", "hermitian"), ("pattern", "general"), ("pattern", "symmetric")]


@pytest.mark.parametrize("field,sym", CASES)
def test_read_coordinate_matches_jax(ast, tmp_path, field, sym):
    astj, mm = ast
    p = tmp_path / "a.mtx"
    text = _coordinate(p, field, sym, seed=len(field) + len(sym))
    want = mm.read_mtx_arrays(str(p))
    _eq_arrays(read_mtx_arrays(str(p)), want)
    _eq_arrays(read_mtx_arrays(text), want)  # the file's own text
    T, J = read_mtx(str(p), device="cpu"), astj.io.read_mtx(str(p))
    got_e, want_e = tt.export_csr(T), astj.export_csr(J)
    assert tuple(got_e[:3]) == tuple(int(v) for v in want_e[:3])
    for g, w in zip(got_e[3:], want_e[3:]):
        np.testing.assert_array_equal(g, np.asarray(w))


@pytest.mark.parametrize("sym", ["general", "symmetric"])
def test_read_array_matches_jax(ast, tmp_path, sym):
    _astj, mm = ast
    rng = np.random.default_rng(5)
    m = 7
    if sym == "general":
        vals = rng.standard_normal(m * 5)
        head = f"{m} 5"
    else:
        vals = rng.standard_normal(m * (m + 1) // 2)
        head = f"{m} {m}"
    p = tmp_path / "d.mtx"
    p.write_text(f"%%MatrixMarket matrix array real {sym}\n{head}\n" + "\n".join(f"{v:.17g}" for v in vals) + "\n")
    _eq_arrays(read_mtx_arrays(str(p)), mm.read_mtx_arrays(str(p)))


@pytest.mark.parametrize("dtype", [np.float64, np.complex128])
def test_write_read_roundtrip_matches_jax(ast, tmp_path, dtype):
    astj, mm = ast
    rng = np.random.default_rng(6)
    S = sp.random(31, 17, density=0.25, random_state=rng, format="csr")
    data = S.data.astype(dtype) + (1j * rng.standard_normal(S.nnz) if dtype == np.complex128 else 0)
    T = tt.create_csr(31, 17, S.indptr, S.indices, data, device="cpu")
    J = astj.create_csr(31, 17, S.indptr, S.indices, data)
    pt, pj = tmp_path / "t.mtx", tmp_path / "j.mtx"
    write_mtx(str(pt), T)
    mm.write_mtx(str(pj), J)
    assert pt.read_text() == pj.read_text()
    back = read_mtx(str(pt), device="cpu")
    for g, w in zip(tt.export_csr(back)[3:], (S.indptr, S.indices, data)):
        np.testing.assert_array_equal(g, w)
    assert back.dtype == torch.from_numpy(data).dtype


def test_gzip_dtype_and_bad_header_match_jax(ast, tmp_path):
    astj, mm = ast
    p = tmp_path / "g.mtx"
    text = _coordinate(p, "real", "symmetric", seed=8)
    gz = tmp_path / "g.mtx.gz"
    with gzip.open(gz, "wt") as f:
        f.write(text)
    _eq_arrays(read_mtx_arrays(str(gz)), mm.read_mtx_arrays(str(gz)))
    T = read_mtx(str(gz), dtype=np.float32, device="cpu")
    assert T.dtype == torch.float32
    np.testing.assert_array_equal(tt.export_csr(T)[5], np.asarray(astj.export_csr(astj.io.read_mtx(str(gz), dtype=np.float32))[5]))
    bad = tmp_path / "bad.mtx"
    bad.write_text("%%NotMatrixMarket matrix coordinate real general\n1 1 0\n")
    short = tmp_path / "short.mtx"
    short.write_text("%%MatrixMarket matrix coordinate real general\n3 3 2\n1 1 1.0\n")
    for path in (bad, short):
        with pytest.raises(tt.AoclSparseError) as e:
            read_mtx_arrays(str(path))
        with pytest.raises(astj.AoclSparseError) as ej:
            mm.read_mtx_arrays(str(path))
        assert int(e.value.status) == int(ej.value.status) == int(tt.Status.invalid_value)


def test_scipy_written_symmetric_file(tmp_path):
    """A symmetric file of a lower triangle written by scipy.io.mmwrite
    reads back as the full matrix."""
    rng = np.random.default_rng(9)
    S = sp.random(40, 40, density=0.1, random_state=rng, format="csr")
    full = (S + S.T).tocsr()
    full.sort_indices()
    p = tmp_path / "s.mtx"
    scipy.io.mmwrite(str(p), sp.tril(full).tocoo(), symmetry="symmetric")
    T = read_mtx(str(p), device="cpu")
    m, n, nnz, ptr, ind, val = tt.export_csr(T)
    np.testing.assert_array_equal(ptr, full.indptr)
    np.testing.assert_array_equal(ind, full.indices)
    np.testing.assert_allclose(val, full.data, rtol=0, atol=0)
