"""The port's dry run (``repro_torch.launch.dryrun``) against the
reference's record schema and the reference's cost analysis.

Cells run in this process on meta shards (no child process, no card),
at the reference's smoke shapes or reduced size:

  * the record schema of ``tests/test_dryrun_smoke.py`` (``OK_KEYS``,
    ``MEMORY_KEYS``, the three terms, scalar ``cost_analysis_raw``) on
    the reference's smoke cells, 8 shards;
  * error cells are loud; cells are ``skipped`` exactly where the
    reference's ``supports()`` skips them;
  * the ``stencil-suite`` cells count one ``collective-permute`` per
    direction, sharded axis and temporal block;
  * ``model_flops`` is the reference's 6·N·D / 2·N·D (its configs'
    ``n_active_params``);
  * the shortcuts (one representative shard, attention blocks counted
    by trip count) count what a full replay over every shard and block
    counts: exactly for serving, and for a train step the dot flops
    exactly (within 3 % under remat) and the rest within 0.1 %;
  * ``dot_flops`` of an unsharded reduced prefill within 1 % of the
    reference's ``hlo_cost`` of the compiled program.

``repro.launch.dryrun`` itself is never imported here: it sets the
device count of jax at import.
"""
import dataclasses

import jax
import jax.numpy as jnp
import pytest
import torch

import repro.configs as RC
import repro_torch.configs as TC
from repro.analysis import hlo_cost
from repro.models import transformer as RT
from repro.models.params import tree_abstract
from repro.serve import serve_step as rserve
from repro_torch.api.sharded import planned_exchange_rounds
from repro_torch.launch import dryrun as DR
from repro_torch.launch.mesh import make_host_mesh, make_mesh
from test_dryrun_smoke import MEMORY_KEYS, OK_KEYS, assert_ok_schema

LM_ARCHS = [a for a in RC.list_archs() if a != "stencil-suite"]


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """Meta tensors carry no data: one intra-op thread is plenty."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def smoke(n=8):
    return make_mesh((n // 4, 4), ("data", "model"), devices=[DR.META] * n)


def meta_mesh(shape):
    return make_host_mesh(*shape, devices=[DR.META] * (shape[0] * shape[1]))


# ============================================================= records ==
@pytest.mark.parametrize("arch", ["mamba2-130m", "h2o-danube-1.8b"])
@pytest.mark.parametrize("shape", ["decode_32k", "long_500k"])
def test_ok_records_pass_the_reference_schema(arch, shape, tmp_path):
    """The reference's smoke cells at full width on 8 meta shards: every
    key of its schema, ``memory_derivation`` beside ``memory``, XLA's
    collective names."""
    rec = DR.run_cell(arch, shape, smoke(), "smoke", str(tmp_path))
    assert_ok_schema(rec)
    assert OK_KEYS <= set(rec) and MEMORY_KEYS == set(rec["memory"])
    assert set(rec["memory_derivation"]) == MEMORY_KEYS
    assert rec["memory"]["code_bytes"] == 0
    assert set(rec["hlo"]) == {
        "dot_flops", "ew_flops", "total_flops", "bytes_accessed",
        "coll_count", "coll_result_bytes", "coll_wire_bytes",
        "total_wire_bytes", "total_coll_count"}
    assert set(rec["hlo"]["coll_count"]) <= {"all-reduce", "all-gather"}
    assert rec["hlo"]["total_coll_count"] > 0
    saved = list(tmp_path.iterdir())
    assert len(saved) == 1 and saved[0].name == f"{arch}__{shape}__smoke.json"


def test_dryrun_error_cells_are_loud(tmp_path):
    """A cell that raises is ``status="error"`` with the exception and a
    traceback in the record — never silently ``ok``."""
    rec = DR.run_cell("no-such-arch", "decode_32k", smoke(4), "smoke",
                      str(tmp_path))
    assert rec["status"] == "error"
    assert "no-such-arch" in rec["error"] or "KeyError" in rec["error"]
    assert "Traceback" in rec["traceback"]
    bad = DR.run_cell("mamba2-130m", "no_such_shape", smoke(4), "smoke",
                      str(tmp_path))
    assert bad["status"] == "error" and "no_such_shape" in bad["error"]


@pytest.mark.parametrize("name", ["j2d5pt", "j3d7pt"])
def test_stencil_cells_count_their_exchanges(name, tmp_path):
    """A ``stencil-suite`` cell on 8 shards: one ``collective-permute``
    per direction, sharded axis and temporal block
    (``planned_exchange_rounds`` × 2 × 2 axes), each moving one halo
    slab; the compute term on the fp32 non-tensor peak."""
    rec = DR.run_cell("stencil-suite", name, smoke(), "smoke",
                      str(tmp_path))
    assert_ok_schema(rec)
    n = rec["hlo"]["coll_count"]["collective-permute"]
    assert n > 0
    assert n == planned_exchange_rounds(rec["t_total"], rec["t_block"]) \
        * 2 * 2
    assert rec["terms"]["compute_s"] == pytest.approx(
        rec["model_flops"] / 8 / DR.HW.thr_cmp)


@pytest.mark.parametrize("arch", LM_ARCHS)
def test_cells_skip_where_the_reference_skips(arch, tmp_path):
    """Every arch × shape cell is ``skipped`` exactly where the
    reference's ``supports()`` skips it, with its reason; the others are
    supported in both."""
    for shape in RC.SHAPES:
        ok, why = RC.get_config(arch).supports(shape)
        assert TC.get_config(arch).supports(shape) == (ok, why)
        if not ok:
            rec = DR.run_cell(arch, shape, smoke(), "smoke", str(tmp_path))
            assert rec == {"arch": arch, "shape": shape, "mesh": "smoke",
                           "n_chips": 8, "status": "skipped",
                           "reason": why}


@pytest.mark.parametrize("arch", LM_ARCHS)
def test_model_flops_are_the_references(arch):
    """``model_flops``: 6·N·D for train, 2·N·D for inference, N the
    reference's ``n_active_params`` (decode: D = the batch)."""
    n = RC.get_config(arch).n_active_params()
    assert TC.get_config(arch).n_active_params() == n
    for shape, info in RC.SHAPES.items():
        tokens = info["batch"] * (info["seq"] if info["kind"] != "decode"
                                  else 1)
        want = (6.0 if info["kind"] == "train" else 2.0) * n * tokens
        assert DR.model_flops(TC.get_config(arch), shape) == want


def test_hardware_terms_are_the_h100_models():
    """No TPU figure: the terms read the H100 model's bf16 tensor peak,
    memory rate, NVLink links and memory capacity."""
    from repro_torch.core import roofline as trl
    assert DR.HW is trl.H100
    assert trl.H100.mxu_flops == trl.H100_BF16_TENSOR_FLOPS == 989e12
    assert trl.H100.hbm_bytes == trl.H100_HBM_BYTES == 80e9
    hlo = {"dot_flops": 989e12, "bytes_accessed": 3.35e12,
           "total_wire_bytes": 450e9}
    terms, _ = DR.roofline_terms(hlo, 1, None)
    assert terms == pytest.approx({"compute_s": 1.0, "memory_s": 1.0,
                                   "collective_s": 1.0})


# ============================================================ shortcuts ==
def _reduced(name):
    return TC.get_config(name).reduced()


@pytest.mark.parametrize("kind,batch,seq", [("prefill", 4, 256),
                                            ("decode", 4, 256)])
@pytest.mark.parametrize("name", ["h2o-danube-1.8b", "mamba2-130m",
                                  "granite-moe-3b-a800m"])
def test_shortcut_counts_equal_a_full_replay(name, kind, batch, seq):
    """On a (2, 2) mesh of meta shards: one representative shard with the
    attention blocks counted by trip count counts, per device, exactly
    what a replay over all four shards and every block counts (its
    totals over 4); the collectives are the same calls."""
    mesh = meta_mesh((2, 2))
    fast = DR.lm_record(_reduced(name), kind, batch, seq, mesh)["hlo"]
    full = DR.lm_record(_reduced(name), kind, batch, seq, mesh,
                        shortcut=False)["hlo"]
    for k in ("dot_flops", "ew_flops", "total_flops", "bytes_accessed"):
        assert fast[k] == full[k] / 4, k
    for k in ("coll_count", "coll_result_bytes", "coll_wire_bytes"):
        assert fast[k] == full[k], k
    assert fast["dot_flops"] > 0


@pytest.mark.parametrize("remat", [False, True], ids=["", "remat"])
@pytest.mark.parametrize("name", ["h2o-danube-1.8b", "mamba2-130m",
                                  "granite-moe-3b-a800m"])
def test_train_shortcut_equals_a_full_replay_on_a_data_mesh(name, remat):
    """A train step on a (2, 1) mesh, at 2 query blocks of 4 key chunks:
    the representative with its attention blocks counted by trip count,
    forward and backward, counts what each shard of a full replay does:
    ``dot_flops`` exactly, and the elementwise flops and bytes within
    0.1 %: the single-process step computes the optimizer's step scalars
    (learning rate, bias corrections, clip scale) once, on the first
    device, where the representative computes them as every SPMD device
    does; autograd adds the gradients of a tensor gathered into several
    positions in another order of copies (the MoE's tokens); and the
    representative key chunk's carry gets the last chunk's gradients.
    Under remat the dot flops agree within 3 %, the replay's above:
    ``torch.utils.checkpoint`` stops its recompute once the backward's
    saved tensors are back, so the layer's last product (``w_down``,
    ``out_proj``) is recomputed for every position but the last in the
    lockstep replay, and never for the representative (nor on an SPMD
    device); the counted attention blocks keep their saved tensors
    outside the remat unit, which moves that stop too.  On meshes with a
    ``model`` axis the single-process replay also backpropagates from the first position's copy of the
    replicated loss only, so shards off its ``data`` group skip the
    loss's backward there; the representative counts the SPMD step."""
    mesh = meta_mesh((2, 1))
    cfg = dataclasses.replace(_reduced(name), remat=remat)
    fast = DR.lm_record(cfg, "train", 4, 256, mesh)["hlo"]
    full = DR.lm_record(cfg, "train", 4, 256, mesh, shortcut=False)["hlo"]
    if remat:
        assert 0 <= full["dot_flops"] / 2 - fast["dot_flops"] <= \
            0.03 * fast["dot_flops"]
    else:
        assert fast["dot_flops"] == full["dot_flops"] / 2 > 0
    for k in ("ew_flops", "bytes_accessed"):
        assert abs(fast[k] - full[k] / 2) <= (0.03 if remat else 1e-3) \
            * fast[k], k
    assert fast["coll_count"] == full["coll_count"]


def test_dot_flops_match_the_references_hlo_cost():
    """An unsharded reduced prefill of h2o-danube: the port's
    ``dot_flops`` (``FlopCounterMode``'s formulas over the meta trace)
    within 1 % of ``hlo_cost.analyze`` of the reference's compiled
    prefill on one CPU device.  Both chunk the attention the same way
    (every (query block, key chunk) pair computed, 4 × 4 at S = 256)."""
    name, b, s = "h2o-danube-1.8b", 2, 256
    r = dataclasses.replace(RC.get_config(name).reduced())
    p_abs = tree_abstract(RT.param_defs(r), r.param_dtype)
    fn = jax.jit(rserve.make_prefill(r, cache_len=s))
    text = fn.lower(p_abs, {"tokens": jax.ShapeDtypeStruct(
        (b, s), jnp.int32)}).compile().as_text()
    want = hlo_cost.analyze(text).dot_flops
    got = DR.lm_record(_reduced(name), "prefill", b, s,
                       meta_mesh((1, 1)))["hlo"]["dot_flops"]
    assert abs(got - want) <= 0.01 * want, (got, want)
