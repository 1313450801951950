"""Plan snapshots of the PyTorch port (io/plancache.py): the six cases of
tests/test_plancache.py (a round trip whose values come from the live
handle, a different structure refused, the trsv pins kept, the gen
composite restored, a path without .npz, the mm pin kept) on the port, plus
the port's own: mv and mm(kid=6) bit-equal after a load, the kinds of the
stored fields (bf16 tensors, the route form rebuilt, derived caches not
stored), a gen form shared by two slots stored once, and another
package's snapshot refused.

Operands are made from a seed with numpy. Values are compared with
utils/tolerances.py's expected_precision(dtype) on max |a - b| / max(|b|, 1)
against a dense float64 product, or bit for bit where the restored form is
the same form.
"""

import numpy as np
import pytest
import scipy.sparse as sp
import torch

import aoclsparse_tpu_torch as tt
from aoclsparse_tpu_torch.io import load_plan, save_plan
from aoclsparse_tpu_torch.planner import plan as tplan
from aoclsparse_tpu_torch.planner.plan import get_plan
from aoclsparse_tpu_torch.planner.triangular import trsv_form_for
from aoclsparse_tpu_torch.utils.tolerances import expected_precision, near_error

GEN = tt.MatrixDescriptor()
NONE = tt.Operation.none
KEY4 = (GEN.type, GEN.fill_mode, GEN.diag_type, NONE)


@pytest.fixture
def rng():
    return np.random.default_rng(11)


def _circuitish(rng, m):
    """tests/test_plancache.py `_circuitish`: a band of 4 entries a row
    within +-8, plus m/2 entries in one hub column."""
    rows = np.repeat(np.arange(m), 4)
    cols = np.clip(rows + rng.integers(-8, 9, rows.size), 0, m - 1)
    r = np.concatenate([rows, rng.integers(0, m, m // 2)])
    c = np.concatenate([cols, np.full(m // 2, 7)])
    S = sp.csr_matrix((rng.standard_normal(r.size), (r, c)), shape=(m, m))
    S.sum_duplicates()
    S.sort_indices()
    return S


def _h(S, val=None, dtype=np.float64):
    return tt.create_csr(S.shape[0], S.shape[1], S.indptr, S.indices,
                         (S.data if val is None else val).astype(dtype), device="cpu")


def test_save_load_roundtrip_values_from_live_handle(rng, tmp_path):
    S = _circuitish(rng, 2048)
    A = _h(S)
    form = get_plan(A).exec_form_for(GEN, NONE)
    p = tmp_path / "plan.npz"
    save_plan(A, p)
    # a fresh handle, the same structure, DIFFERENT values: the snapshot's
    # values must not leak in
    B = _h(S, 3 * S.data)
    assert load_plan(B, p) >= 1
    assert get_plan(B).exec_form_for(GEN, NONE).kind == form.kind
    x = rng.standard_normal(2048)
    y = tt.mv(1.0, B, GEN, NONE, x, 0.0)
    assert near_error(y.numpy(), 3 * (S @ x)) <= expected_precision(torch.float64)
    tt.update_values(B, S.data)  # restored forms stay refreshable
    assert near_error(tt.mv(1.0, B, GEN, NONE, x, 0.0).numpy(), S @ x) <= expected_precision(torch.float64)


def test_load_rejects_different_structure(rng, tmp_path):
    S = _circuitish(rng, 256)
    A = _h(S)
    get_plan(A).exec_form_for(GEN, NONE)
    p = tmp_path / "plan.npz"
    save_plan(A, p)
    C = tt.create_csr(256, 256, S.indptr, np.clip(S.indices + 1, 0, 255), S.data, device="cpu")
    with pytest.raises(tt.AoclSparseError) as e:
        load_plan(C, p)
    assert e.value.status == tt.Status.invalid_value


def test_save_load_preserves_autotune_pins(rng, tmp_path):
    m = 1536
    dense = np.tril(rng.standard_normal((m, m)) * (rng.random((m, m)) < 0.01), -1) + np.diag(4 + rng.random(m))
    S = sp.csr_matrix(dense)
    A = _h(S)
    low = tt.MatrixDescriptor(type=tt.MatrixType.triangular)
    t = tt.autotune_trsv(A, low, nb_candidates=(128, 256), iters=1, chunks=1)
    winner = min(t, key=t.get)
    get_plan(A)._mv_engine[KEY4] = "host"  # every pin table travels
    p = tmp_path / "plan.npz"
    save_plan(A, p)
    B = _h(S)
    load_plan(B, p)
    key = (low.fill_mode, low.diag_type, NONE)
    assert get_plan(B)._mv_engine == {KEY4: "host"}
    if winner in ("level", "host"):
        assert get_plan(B)._trsv_engine.get(key) == winner
    else:
        assert get_plan(B)._trsv_tuned == {key: winner}
        assert trsv_form_for(get_plan(B), low, NONE).nb == winner
    b = rng.standard_normal(m)
    x = tt.trsv(1.0, B, low, NONE, b)
    assert near_error(dense @ x.numpy(), b) <= expected_precision(torch.float64)


def test_gen_form_snapshot_roundtrip(rng, tmp_path):
    """The expensive case the cache exists for: the gen composite's RCM,
    hub and spill analysis restores without re-running; mv and mm(kid=6) on
    the loaded plan are bit-equal to the original handle's."""
    m = 4096
    S = _circuitish(rng, m)
    A = _h(S, dtype=np.float32)
    form = get_plan(A).exec_form_for(GEN, NONE, kind="gen")
    assert form.kind == "gen" and form.gen_bandt
    x = torch.from_numpy(rng.standard_normal(m).astype(np.float32))
    Bm = torch.from_numpy(rng.standard_normal((m, 12)).astype(np.float32))
    y0 = tt.mv(1.0, A, GEN, NONE, x, 0.0, kid=7)
    c0 = tt.mm(1.0, A, GEN, NONE, Bm, 0.0, kid=6)
    p = tmp_path / "plan.npz"
    save_plan(A, p)
    B = _h(S, dtype=np.float32)
    assert load_plan(B, p) >= 1
    formB = get_plan(B).exec_forms[KEY4 + ("gen",)]
    assert formB.kind == "gen" and formB._derived is None and formB._spill_route is None
    assert torch.equal(tt.mv(1.0, B, GEN, NONE, x, 0.0, kid=7), y0)
    assert torch.equal(tt.mm(1.0, B, GEN, NONE, Bm, 0.0, kid=6), c0)
    assert near_error(y0.numpy(), S @ x.double().numpy()) <= expected_precision(torch.float32)


def test_a_shared_gen_form_is_stored_once(rng, tmp_path):
    """The mv default and mm KID 6 share one gen form (Plan.gen_form_for):
    the snapshot stores it once and the load restores one form in both
    slots, so the default's mv stays bit-equal."""
    import json

    m = 4096
    S = _circuitish(rng, m)
    A = _h(S, dtype=np.float32)
    plan = get_plan(A)
    assert tplan.choose_mv_format(plan.effective_for(GEN, NONE)) == "gen"
    x = torch.from_numpy(rng.standard_normal(m).astype(np.float32))
    y0 = tt.mv(1.0, A, GEN, NONE, x, 0.0)
    tt.mm(1.0, A, GEN, NONE, torch.ones(m, 4), 0.0, kid=6)
    assert plan.exec_forms[KEY4 + (None,)] is plan.exec_forms[KEY4 + ("gen",)]
    p = tmp_path / "plan.npz"
    save_plan(A, p)
    with np.load(p) as npz:
        entries = json.loads(bytes(npz["__manifest__"]).decode())["exec_forms"]
    assert sum("same_as" in e for e in entries) == 1
    B = _h(S, dtype=np.float32)
    load_plan(B, p)
    planB = get_plan(B)
    assert planB.exec_forms[KEY4 + (None,)] is planB.exec_forms[KEY4 + ("gen",)]
    assert torch.equal(tt.mv(1.0, B, GEN, NONE, x, 0.0), y0)


def test_save_load_bare_path(rng, tmp_path):
    """A path without .npz works for both save and load (np.savez appends
    the extension; load stays symmetric)."""
    S = _circuitish(rng, 128)
    A = _h(S)
    get_plan(A).exec_form_for(GEN, NONE)
    p = str(tmp_path / "plan")
    save_plan(A, p)
    assert load_plan(_h(S), p) >= 1


def test_snapshot_persists_mm_tuned_pin(rng, tmp_path):
    m, k = 64, 8
    S = sp.random(m, m, density=0.3, random_state=np.random.RandomState(3), format="csr")
    S.sort_indices()
    A = _h(S)
    tt.autotune_mm(A, k=k, iters=1, chunks=1)
    pin = dict(get_plan(A)._mm_tuned)
    assert pin
    save_plan(A, tmp_path / "plan.npz")
    A2 = _h(S)
    load_plan(A2, tmp_path / "plan.npz")
    assert get_plan(A2)._mm_tuned == pin


def test_field_kinds_bf16_and_the_route_rebuild(rng, tmp_path, monkeypatch):
    """bf16 tensors travel as their bit pattern; the whole-matrix route
    (no array form) is not stored and rebuilds at first use; the loaded
    tensors lie on the handle's device."""
    S = _circuitish(rng, 1024)
    Ab = tt.create_csr(1024, 1024, S.indptr, S.indices, torch.from_numpy(S.data).to(torch.bfloat16), device="cpu")
    x = torch.from_numpy(rng.standard_normal(1024)).to(torch.bfloat16)
    y0 = tt.mv(1.0, Ab, GEN, NONE, x, 0.0)
    save_plan(Ab, tmp_path / "b.npz")
    Bb = tt.create_csr(1024, 1024, S.indptr, S.indices, torch.from_numpy(S.data).to(torch.bfloat16), device="cpu")
    load_plan(Bb, tmp_path / "b.npz")
    fb = get_plan(Bb).exec_forms[KEY4 + (None,)]
    assert fb.bwd_val.dtype == torch.bfloat16 and fb.bwd_val.device.type == "cpu"
    assert torch.equal(tt.mv(1.0, Bb, GEN, NONE, x, 0.0), y0)
    monkeypatch.setattr(tplan, "ROUTE_MIN_NNZ", 0)
    rr = np.random.default_rng(5)
    U = sp.csr_matrix((rr.standard_normal(6144), (np.repeat(np.arange(2048), 3), rr.integers(0, 2048, 6144))),
                      shape=(2048, 2048))
    U.sum_duplicates()
    U.sort_indices()
    Q = _h(U, dtype=np.float32)
    assert get_plan(Q).exec_form_for(GEN, NONE).kind == "route"
    save_plan(Q, tmp_path / "q.npz")
    Q2 = _h(U, dtype=np.float32)
    assert load_plan(Q2, tmp_path / "q.npz") == 0
    xq = torch.from_numpy(rr.standard_normal(2048).astype(np.float32))
    assert near_error(tt.mv(1.0, Q2, GEN, NONE, xq, 0.0).numpy(), U @ xq.double().numpy()) <= expected_precision(
        torch.float32)


def test_another_packages_snapshot_is_refused(rng, tmp_path):
    ast = pytest.importorskip("aoclsparse_tpu")
    from aoclsparse_tpu.io.plancache import save_plan as jsave

    S = _circuitish(rng, 256)
    J = ast.create_csr(256, 256, S.indptr, S.indices, S.data)
    ast.mv(1.0, J, ast.MatrixDescriptor(), ast.Operation.none, np.ones(256), 0.0)
    jsave(J, str(tmp_path / "j.npz"))
    with pytest.raises(tt.AoclSparseError) as e:
        load_plan(_h(S), tmp_path / "j.npz")
    assert e.value.status == tt.Status.invalid_value
