"""The port's dry run (``repro_torch.launch.dryrun``) against the JAX
package: the shapes and their runnability, the batch and cache specs,
the parameter counts of all ten configs at full width (on ``meta``), the
roofline arithmetic under the reference's constants, the report's
tables character for character, the cost counter (meta against CPU
tensors, matmul FLOPs against their closed form and against XLA's count
of the reference's step), the dry collectives' bytes against the byte
predictors, ``hillclimb --cell`` (its refused variants, smoke and
full-width records in one directory), counting in processes and
``backend_info``.

The JAX side never imports ``repro.launch.dryrun``: it sets
``XLA_FLAGS`` to 512 host devices at import, in a worker other test
files share.  Its pieces are imported one by one.
"""
import functools
import math
import re

import jax
import numpy as np
import pytest
import torch

from repro.configs import ARCHS as JARCHS
from repro.configs import SHAPES as JSHAPES
from repro.configs import cell_is_runnable as jrunnable
from repro.configs import decode_specs as jdecode_specs
from repro.configs import smoke_config as jsmoke
from repro.configs import train_batch_specs as jtrain_specs
from repro.configs.base import ShapeConfig as JShapeConfig
from repro.models import get_model as jget_model
from repro.roofline import analysis as ja
from repro.roofline import report as jreport
from repro.train.optimizer import AdamW as JAdamW
from repro.train.train_step import init_state as jinit_state
from repro.train.train_step import make_train_step as jmake_train_step
from repro_torch import configs as tconfigs
from repro_torch.configs.base import ShapeConfig
from repro_torch.core.tree import key_str, tree_leaves, tree_leaves_with_path
from repro_torch.launch import backend, dryrun, hillclimb
from repro_torch.launch.mesh import make_dry_mesh
from repro_torch.models import get_model
from repro_torch.models import transformer
from repro_torch.models.moe import ShardingCtx, apply_moe
from repro_torch.roofline import analysis as ta
from repro_torch.roofline import report as treport
from repro_torch.train.optimizer import AdamW
from repro_torch.train.train_step import TrainState, make_train_step
from repro_torch.tune.moe import MoeDispatchSchedule

ARCH_NAMES = sorted(JARCHS)
#: One architecture of each family.
FAMILY_ARCHS = {"dense": "qwen2-7b", "moe": "qwen3-moe-235b-a22b",
                "ssm": "mamba2-2.7b", "hybrid": "hymba-1.5b",
                "encdec": "whisper-large-v3", "vlm": "paligemma-3b"}
SMALL = ShapeConfig("small", seq_len=16, global_batch=4, kind="train")
MATMULS = ("aten.mm", "aten.bmm", "aten.addmm")


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """Torch on one thread: small problems under parallel workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _smoke(name):
    return tconfigs.smoke_config(tconfigs.get_config(name)).scaled(
        moe_kernel_dispatch=False)


def _matmul_flops(counter) -> int:
    return sum(f for op, (f, _) in counter.by_op.items() if op in MATMULS)


# ---------------------------------------------------------------- shapes


def test_shapes_and_runnability_match_the_reference():
    """All ten archs x four shapes: the same verdict and reason."""
    assert {k: (s.seq_len, s.global_batch, s.kind)
            for k, s in tconfigs.SHAPES.items()} == {
        k: (s.seq_len, s.global_batch, s.kind) for k, s in JSHAPES.items()}
    for arch in ARCH_NAMES:
        for shape in JSHAPES:
            assert tconfigs.cell_is_runnable(
                tconfigs.get_config(arch), tconfigs.SHAPES[shape]) == \
                jrunnable(JARCHS[arch], JSHAPES[shape]), (arch, shape)


def _jax_leaves(tree):
    return {"/".join(str(getattr(k, "key", getattr(k, "idx", k)))
                     for k in path): leaf
            for path, leaf in jax.tree_util.tree_leaves_with_path(tree)}


@pytest.mark.parametrize("arch", ARCH_NAMES)
def test_batch_and_cache_specs_match_the_reference(arch):
    """``train_batch_specs`` and ``decode_specs`` at full width: the
    reference's shapes and types, every cache leaf at its path (the
    port's caches keep the reference's leading L), on meta."""
    tcfg, jcfg = tconfigs.get_config(arch), JARCHS[arch]
    for name in ("train_4k", "prefill_32k"):
        got = tconfigs.train_batch_specs(tcfg, tconfigs.SHAPES[name])
        want = jtrain_specs(jcfg, JSHAPES[name])
        assert {k: (tuple(v.shape), str(v.dtype).split(".")[-1])
                for k, v in got.items()} == {
            k: (v.shape, str(v.dtype)) for k, v in want.items()}
        assert all(v.device.type == "meta" for v in got.values())
    shape = "long_500k" if tcfg.sub_quadratic else "decode_32k"
    got = tconfigs.decode_specs(tcfg, tconfigs.SHAPES[shape],
                                get_model(tcfg).init_cache)
    want = jdecode_specs(jcfg, JSHAPES[shape], jget_model(jcfg).init_cache)
    assert tuple(got["tokens"].shape) == want["tokens"].shape
    tcache = {key_str(p): v for p, v in tree_leaves_with_path(got["cache"])
              if isinstance(v, torch.Tensor)}
    jcache = {p: v for p, v in _jax_leaves(want["cache"]).items()
              if v.shape != ()}
    assert {p: (tuple(v.shape), str(v.dtype).split(".")[-1])
            for p, v in tcache.items()} == {
        p: (v.shape, str(v.dtype)) for p, v in jcache.items()}


@pytest.mark.parametrize("arch", ARCH_NAMES)
def test_full_width_parameter_counts_equal_the_reference(arch):
    """``count_params`` and ``count_active_params`` of the port's meta
    tree equal the reference's over ``jax.eval_shape(api.init, key)``,
    exactly; the meta tree holds no storage."""
    tcfg, jcfg = tconfigs.get_config(arch), JARCHS[arch]
    params = get_model(tcfg).init(torch.Generator(), device="meta")
    assert all(t.device.type == "meta" for t in tree_leaves(params))
    shapes = jax.eval_shape(jget_model(jcfg).init, jax.random.PRNGKey(0))
    assert ta.count_params(params) == ja.count_params(shapes)
    assert ta.count_active_params(params, tcfg) == \
        ja.count_active_params(shapes, jcfg)


@pytest.mark.parametrize("arch", sorted(FAMILY_ARCHS.values()))
def test_meta_init_has_the_real_init_shapes(arch):
    """The shape-only tree equals a real draw's shapes and types, and a
    meta init leaves the generator as it was."""
    cfg = _smoke(arch)
    api = get_model(cfg)
    gen = torch.Generator().manual_seed(3)
    meta = api.init(gen, device="meta")
    assert torch.equal(gen.get_state(),
                       torch.Generator().manual_seed(3).get_state())
    real = api.init(gen, device="cpu")
    assert [(key_str(p), tuple(t.shape), t.dtype)
            for p, t in tree_leaves_with_path(meta)] == [
        (key_str(p), tuple(t.shape), t.dtype)
        for p, t in tree_leaves_with_path(real)]


# ------------------------------------------------------------ arithmetic


def _costs(i):
    return {"flops": 3.0e12 + i, "bytes": 5.0e10 * (i + 1),
            "coll_bytes": 7.0e8 * i,
            "collectives": {"all-reduce": {"count": 3 + i,
                                           "bytes": 7.0e8 * i}}}


@pytest.mark.parametrize("kind", ["train", "prefill", "decode"])
def test_analyze_and_combine_equal_the_reference(kind):
    """Under the reference's constants passed explicitly, ``analyze`` and
    ``combine_costs`` give the reference's records exactly."""
    ref_hw = ta.Hardware("reference", ja.PEAK_FLOPS, ja.HBM_BW, ja.ICI_BW,
                         ta.HBM_BYTES)
    base, body = _costs(1), _costs(2)
    body["collectives"]["all-gather"] = {"count": 2, "bytes": 1.0e6}
    combined = ta.combine_costs(base, body, 5)
    assert combined == ja.combine_costs(base, body, 5)
    ma = ta.MemoryRecord(12_000_000_000, 3_000_000_000, 9_000_000_000)
    kw = dict(n_chips=256, kind=kind, tokens=1_048_576,
              n_params=7_070_619_136, n_active_params=7_070_619_136)
    assert ta.analyze(combined, ma, hw=ref_hw, **kw) == \
        ja.analyze(combined, ma, **kw)
    assert ta.analyze(combined, None, hw=ref_hw, **kw) == \
        ja.analyze(combined, None, **kw)
    # the card's constants move the terms, not the record's shape
    card = ta.analyze(combined, ma, **kw)
    assert card.keys() == ja.analyze(combined, ma, **kw).keys()
    assert card["terms_s"]["compute"] == combined["flops"] / 989.4e12


def test_dtype_itemsize_and_link_rates():
    for name, n in (("bf16", 2), ("f8e4m3fn", 1), ("bfloat16", 2),
                    ("float8_e4m3fn", 1), ("float32", 4)):
        assert ta.dtype_itemsize(name) == n
    assert ta.dtype_itemsize(torch.bfloat16) == 2
    assert ta.dtype_itemsize(np.int64) == 8
    assert ta.link_bw_for(8) == ta.NVLINK_BW == 450e9
    assert ta.link_bw_for(16) == ta.INTERNODE_BW == ta.H100.link_bw


# ---------------------------------------------------------------- report


@pytest.fixture(scope="module")
def records(tmp_path_factory):
    """Records of smoke cells on both meshes, a skip record and a tagged
    variant, as the dry run writes them."""
    out = tmp_path_factory.mktemp("dryrun")
    smoke = hillclimb._smoke_overrides("qwen2-7b")
    for shape in ("prefill_32k", "decode_32k", "long_500k"):
        dryrun.run_cell("qwen2-7b", shape, overrides=smoke, out_dir=out)
    dryrun.run_cell("qwen2-7b", "decode_32k", overrides=smoke, out_dir=out,
                    multi_pod=True)
    dryrun.run_cell("qwen2-7b", "train_4k", overrides=smoke, out_dir=out)
    dryrun.run_cell("qwen2-7b", "train_4k", overrides=smoke,
                    grad_compression="bf16", tag="gc_bf16", out_dir=out)
    dryrun.run_cell("mamba2-2.7b", "long_500k",
                    overrides=hillclimb._smoke_overrides("mamba2-2.7b"),
                    out_dir=out)
    return out


def test_report_tables_match_the_reference(records):
    recs = treport.load(records)
    assert recs == jreport.load(records)
    assert len(recs) == 7 and ("qwen2-7b", "long_500k", "skip", "") in recs
    for mesh in ("16x16", "2x16x16"):
        assert treport.roofline_table(recs, mesh) == \
            jreport.roofline_table(recs, mesh)
        assert treport.dryrun_table(recs, mesh) == \
            jreport.dryrun_table(recs, mesh)
    assert treport.optimized_table(recs) == jreport.optimized_table(recs)
    assert "gc_bf16" in treport.optimized_table(recs)
    fits = treport.fits_table(recs, "16x16")
    assert len(fits.splitlines()) == 2 + 4 and "| yes |" in fits
    for fn in (treport.fmt_si, jreport.fmt_si):
        assert fn(1.5e12, "B") == "1.50TB"


def test_report_main_prints_every_table(records, capsys):
    treport.main(["--dir", str(records)])
    out = capsys.readouterr().out
    for title in ("Roofline (baseline) — mesh 16x16", "Dry-run detail",
                  "Memory of a rank — mesh 2x16x16", "Optimized variants"):
        assert title in out


# --------------------------------------------------------------- counter


def _train_program(cfg, device, microbatches=1, ctx=None, shape=SMALL,
                   mesh=None):
    api = get_model(cfg)
    gen = torch.Generator().manual_seed(0)
    params = (api.init(gen, device=device) if mesh is None
              else api.init(gen, device=device, mesh=mesh))
    opt = AdamW(lr=1e-3)
    state = TrainState(params, opt.init(params))
    batch = tconfigs.batch_from_specs(
        tconfigs.train_batch_specs(cfg, shape),
        torch.Generator().manual_seed(1), device="cpu")
    batch = {k: v.to(device) for k, v in batch.items()}
    step = make_train_step(api, opt, ctx, microbatches=microbatches)
    return lambda: step(state, batch)


@pytest.mark.parametrize("family", sorted(FAMILY_ARCHS))
def test_counter_counts_the_same_on_meta_and_cpu(family):
    """A smoke training step of each family: the same FLOPs and bytes on
    meta as on CPU tensors (the fused attention counted by its operands,
    whichever backend runs it)."""
    cfg = _smoke(FAMILY_ARCHS[family])
    counts = {}
    for dev in ("cpu", "meta"):
        run = _train_program(cfg, dev, microbatches=2)
        with ta.count_costs() as c:
            run()
        counts[dev] = (c.flops, c.bytes)
        assert c.flops > 0 and c.bytes > 0 and c.peak_bytes > 0
    assert counts["meta"] == counts["cpu"]


def _dense_closed_form(cfg, b, s) -> int:
    """Matmul FLOPs of a dense training step: every weight's product
    forward and its two products backward (6 per parameter and token),
    the tied unembedding on the S - 1 positions the loss reads."""
    swiglu = 3 if cfg.mlp_type == "swiglu" else 2
    per_layer = (2 * cfg.d_model * cfg.attn_dim + 2 * cfg.d_model
                 * cfg.kv_dim + swiglu * cfg.d_model * cfg.d_ff)
    return (6 * b * s * cfg.n_layers * per_layer
            + 6 * b * (s - 1) * cfg.d_model * cfg.vocab_size)


#: The port's matmul FLOPs over XLA's count of the reference's step, on
#: the smoke qwen2-7b at 4 x 16: XLA also counts the elementwise work
#: (norms, rotary, softmax, SiLU, the loss, AdamW's update: some 10-20
#: FLOPs a parameter) and the attention products, which the port's
#: matmuls leave out; at this size they are about a tenth of the step.
XLA_BAND = (0.75, 1.0)


def test_dense_matmul_flops_equal_the_closed_form_and_lie_near_xla():
    cfg = _smoke("qwen2-7b")
    counted = {}
    for mb in (1, 4):
        run = _train_program(cfg, "meta", microbatches=mb)
        with ta.count_costs() as c:
            run()
        counted[mb] = _matmul_flops(c)
    assert counted[1] == counted[4] == _dense_closed_form(
        cfg, SMALL.global_batch, SMALL.seq_len)

    jcfg = jsmoke(JARCHS["qwen2-7b"]).scaled(scan_unroll=True)
    japi = jget_model(jcfg)
    opt = JAdamW(lr=1e-3)
    state = jax.eval_shape(functools.partial(jinit_state, japi, opt),
                           jax.random.PRNGKey(0))
    specs = jtrain_specs(jcfg, JShapeConfig("small", 16, 4, "train"))
    step = jmake_train_step(japi, opt, None, microbatches=1)
    ca = jax.jit(step).lower(state, specs).compile().cost_analysis()
    ca = ca[0] if isinstance(ca, list) else ca
    ratio = counted[1] / float(ca["flops"])
    assert XLA_BAND[0] <= ratio <= XLA_BAND[1], ratio


def test_microbatches_keep_the_matmul_flops_of_a_dry_run_cell():
    smoke = hillclimb._smoke_overrides("qwen2-7b")
    flops = []
    for mb in (1, 8):
        program, _ = dryrun.lower_cell("qwen2-7b", "train_4k",
                                       multi_pod=False, overrides=smoke,
                                       microbatches=mb)
        with ta.count_costs() as c:
            program.run()
        flops.append(_matmul_flops(c))
    assert flops[0] == flops[1] > 0


def test_run_cells_in_processes_equal_the_serial_count(tmp_path):
    """``--jobs``: two spawned processes write the records one process
    writes, but for their timings."""
    cells = [("qwen2-7b", "decode_32k"), ("qwen2-7b", "long_500k"),
             ("qwen2-7b", "train_4k")]
    smoke = hillclimb._smoke_overrides("qwen2-7b")
    recs = []
    for jobs in (1, 2):
        out = tmp_path / str(jobs)
        assert not dryrun.run_cells(cells, jobs=jobs, out_dir=out,
                                    overrides=smoke)
        recs.append(treport.load(out))
    for rec in recs:
        for r in rec.values():
            r.pop("t_lower_s", None)
            r.pop("t_compile_s", None)
    assert len(recs[0]) == 3 and recs[0] == recs[1]


# ---------------------------------------------------- dry collectives


@pytest.mark.parametrize("shape", [(1, 2), (2, 2)])
@pytest.mark.parametrize("mode", ["nnz_ar", "nnz_rs"])
def test_dry_moe_combine_hands_over_the_predicted_bytes(shape, mode):
    cfg = _smoke("qwen3-moe-235b-a22b")
    mesh = make_dry_mesh(shape, ("data", "model"), (shape[0] - 1, 1))
    params = transformer.init_params(cfg, torch.Generator(), device="meta",
                                     mesh=mesh)
    moe = params["layers"][0]["moe"]
    assert moe["wg"].shape[0] == cfg.n_experts // shape[1]
    ctx = ShardingCtx(mesh=mesh, data_axes=("data",), model_axis="model",
                      moe_dispatch=MoeDispatchSchedule(collective=mode))
    t_loc = 24
    x = torch.empty(t_loc, cfg.d_model, device="meta")
    with ta.count_costs() as c:
        out, _ = apply_moe(cfg, moe, x, ctx, dispatch=ctx.moe_dispatch,
                           device="meta")
    want = ta.predict_collective_bytes(mode, (t_loc, cfg.d_model),
                                       axis_size=shape[1])
    # the aux loss's mean over the data axis and over the model axis
    aux = 4 * (shape[0] > 1) + 4
    colls = c.costs()["collectives"]
    if mode == "nnz_ar":
        assert colls["all-reduce"]["bytes"] == want + aux
        assert out.shape == (t_loc, cfg.d_model)
    else:
        assert colls["reduce-scatter"]["bytes"] == want
        assert colls.get("all-reduce", {"bytes": 0})["bytes"] == aux
        assert out.shape == (t_loc // shape[1], cfg.d_model)


@pytest.mark.parametrize("shape", [(1, 2), (2, 2)])
def test_dry_data_parallel_mean_hands_over_the_gradients(shape):
    """The data-parallel step's collectives on a dry mesh under the
    applied specs, each op's count and bytes from the specs alone: each
    gradient's all-reduce over each axis of more than one member its leaf
    is not split over, and its norm's square summed (4 bytes) over each
    it is; the loss's mean over the data axis; over the data axis the
    FSDP attention weights' all-gathers (the whole weight) and their
    reduce-scatters (the rank's block); over the model axis the
    vocabulary-parallel lookup's rows, the loss's features' cotangent,
    its max, sum and gold logit, and each MLP's f and g."""
    from repro_torch.distributed import sharding

    cfg = _smoke("qwen2-7b")
    d, m = shape
    mesh = make_dry_mesh(shape, ("data", "model"))
    ctx = ShardingCtx(mesh=mesh, data_axes=("data",), model_axis="model")
    run = _train_program(cfg, "meta", ctx=ctx, mesh=mesh)
    with ta.count_costs() as c:
        run()
    whole = get_model(cfg).init(torch.Generator(), device="meta")
    specs = sharding.applied_shardings(mesh, whole, cfg.family)
    want = {}

    def add(op, nbytes, n=1):
        row = want.setdefault(op, {"count": 0, "bytes": 0})
        row["count"] += n
        row["bytes"] += nbytes * n

    for path, leaf in tree_leaves_with_path(whole):
        spec = specs[key_str(path)]
        split = sharding.sharded_axes(spec)
        block = leaf.numel() * 4 // math.prod(mesh.shape[a] for a in split)
        for a, n in (("data", d), ("model", m)):
            if n > 1:
                add("all-reduce", 4 if a in split else block)
        if d > 1 and "data" in split:
            add("all-gather", leaf.numel() * 4)
            add("reduce-scatter", block)
    b, s = SMALL.global_batch // d, SMALL.seq_len
    if d > 1:
        add("all-reduce", 4)
    if m > 1:
        rows = b * s * cfg.d_model * 4
        add("all-reduce", rows)  # the lookup
        add("all-reduce", b * (s - 1) * cfg.d_model * 4)  # the loss's x
        add("all-reduce", b * (s - 1) * 4, 3)  # max, sum, gold
        add("all-reduce", rows, 2 * cfg.n_layers)  # the MLPs' f and g
    assert c.costs()["collectives"] == want


def test_a_real_axis_still_needs_a_process_group():
    from repro_torch.distributed import collectives as coll
    from repro_torch.launch.mesh import MeshAxis

    axis = MeshAxis("model", 2, 0, None)
    with pytest.raises((RuntimeError, ValueError)):
        coll.psum(torch.ones(3), axis)


# ------------------------------------------------------- entry points


def test_hillclimb_cell_writes_base_and_variant(tmp_path, capsys):
    hillclimb.main(["--cell", "qwen2-7b:train_4k:gc_bf16", "--smoke",
                    "--out", str(tmp_path)])
    out = capsys.readouterr().out
    assert not list(tmp_path.glob("*.json"))
    assert {p.name for p in (tmp_path / "smoke").glob("*.json")} == {
        "qwen2-7b__train_4k__16x16.json",
        "qwen2-7b__train_4k__16x16__gc_bf16.json"}
    assert "--- qwen2-7b × train_4k [gc_bf16] ---" in out
    assert "frac" in out
    recs = treport.load(tmp_path / "smoke")
    base = recs[("qwen2-7b", "train_4k", "16x16", "")]
    gc = recs[("qwen2-7b", "train_4k", "16x16", "gc_bf16")]
    # the port compresses after the all-reduce: the wire moves the same
    assert gc["collectives"] == base["collectives"]
    assert gc["per_chip"]["hlo_bytes"] > base["per_chip"]["hlo_bytes"]
    with pytest.raises(ValueError, match="seq_parallel_attn"):
        hillclimb.main(["--cell", "qwen2-7b:train_4k:sp", "--smoke",
                        "--out", str(tmp_path)])
    assert set(hillclimb.VARIANTS) == {"mb16", "gc_bf16"}


@pytest.mark.parametrize("tag", sorted(hillclimb.REFUSED))
def test_hillclimb_refuses_what_the_port_lacks(tag, tmp_path):
    """Each refused tag raises with its reason before anything is
    counted, and stays out of the default plan."""
    with pytest.raises(ValueError, match=re.escape(hillclimb.REFUSED[tag])):
        hillclimb.main(["--cell", f"qwen2-7b:decode_32k:{tag}", "--out",
                        str(tmp_path)])
    assert not list(tmp_path.rglob("*.json"))
    assert all(tag not in tags for _, _, tags in hillclimb.DEFAULT_PLAN)


def test_hillclimb_smoke_and_full_records_share_a_directory(tmp_path,
                                                            capsys):
    """A smoke run and a full-width run in one directory each compare
    against the baseline of their own widths; a baseline of other widths
    is counted again, and records of two widths do not compare."""
    for flags in (["--smoke"], [], ["--smoke"]):
        hillclimb.main(["--cell", "qwen2-7b:decode_32k:mb16", "--out",
                        str(tmp_path)] + flags)
    capsys.readouterr()
    name = "qwen2-7b__decode_32k__16x16.json"
    full = tmp_path / name
    smoke = tmp_path / "smoke" / name
    assert treport.load(tmp_path)[("qwen2-7b", "decode_32k", "16x16", "")][
        "overrides"] == {}
    assert treport.load(tmp_path / "smoke")[
        ("qwen2-7b", "decode_32k", "16x16", "mb16")]["overrides"] == \
        hillclimb._smoke_overrides("qwen2-7b")
    # a smoke baseline left under the full-width name is not reused
    full.write_text(smoke.read_text())
    hillclimb.main(["--cell", "qwen2-7b:decode_32k:mb16", "--out",
                    str(tmp_path)])
    assert "--- qwen2-7b × decode_32k [mb16] ---" in capsys.readouterr().out
    assert treport.load(tmp_path)[("qwen2-7b", "decode_32k", "16x16", "")][
        "overrides"] == {}
    full.write_text(smoke.read_text())
    with pytest.raises(ValueError, match="counted under"):
        hillclimb.compare("qwen2-7b", "decode_32k", "mb16", tmp_path)


def test_dryrun_main_writes_a_record_and_a_skip(tmp_path, capsys):
    """The CLI on a cut of full width (the catalog's widths, 1 layer) and
    a skipped cell."""
    dryrun.main(["--arch", "qwen2-7b", "--shape", "long_500k", "--out",
                 str(tmp_path)])
    res = dryrun.run_cell("qwen2-7b", "decode_32k", out_dir=tmp_path,
                          overrides={"n_layers": 1})
    out = capsys.readouterr().out
    assert "SKIP qwen2-7b × long_500k" in out and "dry-run complete" in out
    assert res["fits"] and res["zero1_applied"] is False
    # a rank reads its 1/16 of the weights and of the cache, and
    # all-gathers the layer's FSDP attention weights whole each step
    assert res["dominant"] == "collective"
    assert res["overrides"] == {"n_layers": 1}
    pc = res["per_chip"]
    # the rank's blocks of the weights (its 1/16 of the vocabulary of
    # 152,064 x 3,584 tied, one layer) and its 8 slots of its 1/16 of a
    # 32k cache at bf16: the sequence-sharded KV cache is applied
    held = 8 * (32768 // 16) * 4 * 128 * 2 * 2 + 152064 * 3584 * 2 // 16
    assert held < pc["arg_bytes"] < 2 * held
    assert res["hardware"]["name"] == "NVIDIA H100 80GB HBM3, 700 W"
    assert res["applied"] == ["vocab-sharded embedding", "FSDP attention",
                              "dense MLP split", "sequence-sharded KV cache"]
    assert res["savings"] == {}
    assert len(list(tmp_path.glob("*.json"))) == 2


def test_zero1_shardings_shard_the_moments_over_the_data_axes():
    cfg = tconfigs.get_config("qwen2-7b").scaled(n_layers=1)
    mesh = make_dry_mesh((16, 16), ("data", "model"))
    whole = get_model(cfg).init(torch.Generator(), device="meta")
    from repro_torch.distributed.sharding import param_shardings

    pshard = param_shardings(mesh, whole)
    z = dryrun.zero1_shardings(mesh, whole, pshard)
    assert z["embed"] == ("model", ("data",))
    assert z["layers/0/attn/wq/w"] == pshard["layers/0/attn/wq/w"] == (
        ("data",), None)
    assert z["layers/0/ln1/scale"] == (("data",),)


def test_backend_info_on_the_cpu():
    info = backend.backend_info("cpu")
    assert set(info) == {"backend", "device_kind", "device_count", "fp8",
                         "interpret", "power_limit"}
    assert info["backend"] == "cpu" and info["interpret"] is True
    assert info["power_limit"] is None
    assert backend.setup("cpu") == info
    backend.enable_x64(True)
    try:
        assert torch.get_default_dtype() == torch.float64
    finally:
        backend.enable_x64(False)
    assert math.isclose(ta.H100.peak_flops, 989.4e12)
