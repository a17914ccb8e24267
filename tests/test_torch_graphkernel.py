"""The port's whole-graph mode on the CPU against the JAX package: the
chain partition, the arena plan and the ``(total_steps, 14)`` tables are
the reference's (``np.array_equal``) at both precisions; K2's plain
version (``wave_replay_graph_plain``) equals K1's run node by node and
K4's equals K3's (``torch.equal``); the graphkernel forward is within
``FP32_TOL`` of the JAX ``wave`` executor and ``run_graph_reference``,
and at int8 ``array_equal`` to the JAX int32 walk over the carried
``QuantizedGraph``. Plus the launch plan the CUDA kernels read, the
launcher's checks and the build's header hashing.

The cases: AlexNet at 227x227 (its two chains at the default budget for
batches 1 and 8, the whole network as one chain at 16 MB, the 281-step
chain of the 64 KB plans replayed 1:1), an identity block whose residual
add reads an arena slot, and a block whose shortcut reads the chain
input, so the input is staged into the arena. ResNet-18 and MobileNet-v1
are in test_torch_session_graphkernel_{zoo,mobilenet}.py.
"""
import dataclasses
import functools
import re

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core import graph as jgraph  # noqa: E402
from repro.core import model_zoo as jzoo  # noqa: E402
from repro.core import schedule as jsched  # noqa: E402
from repro.core import streaming as jstream  # noqa: E402
from repro.core.decomposition import ConvLayer as JConvLayer  # noqa: E402
from repro.models.cnn import init_graph_weights as jax_init  # noqa: E402
from repro.quant.accuracy import \
    quant_graph_reference_acts as jax_quant_acts  # noqa: E402
from repro.quant.calibrate import calibrate_graph as jax_calibrate  # noqa: E402,E501
from repro_torch.core import graph as tgraph  # noqa: E402
from repro_torch.core import model_zoo as tzoo  # noqa: E402
from repro_torch.core import schedule as tsched  # noqa: E402
from repro_torch.core import streaming as tstream  # noqa: E402
from repro_torch.core.decomposition import ConvLayer  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels.wave_replay import graph as k2  # noqa: E402
from repro_torch.kernels.wave_replay import kernel as k1  # noqa: E402
from repro_torch.kernels.wave_replay import ops  # noqa: E402
from repro_torch.kernels.wave_replay.ref import fp32_error  # noqa: E402
from repro_torch.kernels.wave_replay_q import graph as k4  # noqa: E402
from repro_torch.kernels.wave_replay_q import kernel as k3  # noqa: E402
from repro_torch.kernels.wave_replay_q import ops as ops_q  # noqa: E402
from repro_torch.models.cnn import weights_from_numpy  # noqa: E402
from repro_torch.quant.calibrate import quantized_graph_from_numpy  # noqa: E402,E501


def blocks(pkg):
    """The identity block (a residual add of the stem's output, held in
    an arena slot) and the staged-input block (c2 + input), built from
    one package's graph types."""
    g = jgraph if pkg == "jax" else tgraph
    layer = JConvLayer if pkg == "jax" else ConvLayer

    def conv(name, ci, co, inputs, relu=True):
        return g.GraphNode(name, "conv", inputs,
                           layer=layer(name, 8, 8, ci, co, 3, pad=1),
                           relu=relu)

    ident = g.NetworkGraph("identity_block", (8, 8, 3), (
        conv("stem", 3, 8, (g.INPUT,)), conv("c1", 8, 8, ("stem",)),
        conv("c2", 8, 8, ("c1",), relu=False),
        g.GraphNode("add", "add", ("c2", "stem"), relu=True)), "add")
    staged = g.NetworkGraph("input_in_arena", (8, 8, 8), (
        conv("c1", 8, 8, (g.INPUT,)), conv("c2", 8, 8, ("c1",), relu=False),
        g.GraphNode("add", "add", ("c2", g.INPUT), relu=True)), "add")
    return {"identity_block": ident, "input_in_arena": staged}


def graph_of(pkg, name):
    if name in ("identity_block", "input_in_arena"):
        return blocks(pkg)[name]
    zoo = jzoo if pkg == "jax" else tzoo
    return zoo.network_graph(name)


# case: (graph, sram budget of the plans, vmem budget, batch)
CASES = {
    "alexnet_b1": ("alexnet", 128 * 1024, tsched.DEFAULT_VMEM_BUDGET, 1),
    "alexnet_b8": ("alexnet", 128 * 1024, tsched.DEFAULT_VMEM_BUDGET, 8),
    "alexnet_16mb": ("alexnet", 128 * 1024, 16 * 2 ** 20, 8),
    "alexnet_281_steps": ("alexnet", 64 * 1024, None, 2),
    "identity_block": ("identity_block", 64 * 1024,
                       tsched.DEFAULT_VMEM_BUDGET, 2),
    "input_in_arena": ("input_in_arena", 64 * 1024,
                       tsched.DEFAULT_VMEM_BUDGET, 2),
}


@functools.lru_cache(maxsize=None)
def programs(pkg, graph, sram):
    g = graph_of(pkg, graph)
    s = jstream if pkg == "jax" else tstream
    return g, s.compile_graph(g, s.plan_graph(g, sram))


@functools.lru_cache(maxsize=None)
def lowered(pkg, case, quantized):
    graph, sram, budget, batch = CASES[case]
    g, progs = programs(pkg, graph, sram)
    s = jstream if pkg == "jax" else tstream
    return s.graph_chain_programs(g, progs, budget, quantized=quantized,
                                  batch=batch)


def norm(v):
    """Dataclasses are distinct types in the two packages; compare them
    by class name and fields."""
    if dataclasses.is_dataclass(v) and not isinstance(v, type):
        return (type(v).__name__,
                tuple(norm(getattr(v, f.name))
                      for f in dataclasses.fields(v)))
    if isinstance(v, (tuple, list)):
        return tuple(norm(x) for x in v)
    if isinstance(v, np.integer):
        return int(v)
    return v


def check_lowering(case, quantized):
    jchains, jk, jg = lowered("jax", case, quantized)
    tchains, tk, tg = lowered("torch", case, quantized)
    assert norm(tchains) == norm(jchains)
    assert list(tk) == list(jk)
    for n in jk:
        np.testing.assert_array_equal(tk[n].operand_table(),
                                      jk[n].operand_table())
    assert list(tg) == list(jg)
    for head, j in jg.items():
        t = tg[head]
        np.testing.assert_array_equal(t.operand_table(), j.operand_table())
        assert norm(t.geometry) == norm(j.geometry)
        for f in ("node_steps", "total_steps", "w_chunks", "w_offsets",
                  "w_max", "w_total", "b_offsets", "b_max", "b_total",
                  "input_value", "input_in_arena", "quantized",
                  "batch_block"):
            assert getattr(t, f) == getattr(j, f), f
        assert norm(t.arena) == norm(j.arena)
        assert t.vmem_bytes == j.vmem_bytes
        assert t.describe() == j.describe()
        tsched.validate_graph_kernel(t)
    return tchains, tg


@pytest.mark.parametrize("quantized", [False, True], ids=["fp32", "int8"])
@pytest.mark.parametrize("case", list(CASES))
def test_chain_partition_arena_and_tables_match_jax(case, quantized):
    chains, gkps = check_lowering(case, quantized)
    want = {"alexnet_b1": [2, 3], "alexnet_b8": [2, 3],
            "alexnet_16mb": [5], "alexnet_281_steps": [5],
            "identity_block": [3], "input_in_arena": [2]}[case]
    assert [len(c.convs) for c in chains] == want
    if case == "alexnet_281_steps":
        assert gkps["conv1"].total_steps == 281
    assert any(g.input_in_arena for g in gkps.values()) == \
        (case == "input_in_arena")


def test_graph_operands_are_the_reference_tables():
    """One table per fused chain, keyed by its head, at both precisions;
    a single-node chain (vmem budget too small to fuse) keeps the
    per-layer table."""
    for prec in ("fp32", "int8"):
        for case in ("alexnet_b8", "identity_block"):
            graph, sram, budget, batch = CASES[case]
            jg, jp = programs("jax", graph, sram)
            tg, tp = programs("torch", graph, sram)
            want = jstream.graph_operands(jg, jp, "graphkernel", budget,
                                          precision=prec, batch=batch)
            got = tstream.graph_operands(tg, tp, "graphkernel", budget,
                                         precision=prec, batch=batch,
                                         device="cpu")
            assert list(got) == list(want)
            for k, v in want.items():
                assert got[k].dtype == torch.int32
                np.testing.assert_array_equal(got[k].numpy(),
                                              np.asarray(v))
    # a budget below any two-node chain: every chain is one node, whose
    # table is the per-layer (n_chain, n_tiles, 8) one
    tg, tp = programs("torch", "identity_block", 64 * 1024)
    jg, jp = programs("jax", "identity_block", 64 * 1024)
    got = tstream.graph_operands(tg, tp, "graphkernel", 1, batch=2,
                                 device="cpu")
    want = jstream.graph_operands(jg, jp, "graphkernel", 1, batch=2)
    assert list(got) == list(want) == ["stem", "c1", "c2"]
    for k in want:
        assert got[k].ndim == 3
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))


# ---------------------------------------------------------------------------
# plan_arena (copies of the reference's cases) and validation
# ---------------------------------------------------------------------------

def arena_values(pkg, rows):
    av = jsched.ArenaValue if pkg == "jax" else tsched.ArenaValue
    return tuple(av(*r) for r in rows)


ARENA_CASES = {
    # a dies at 0 < 1 and b at 1 < 2: c and d reuse their slots
    "reuses_only_dead_slots": (
        [("a", -1, 0, (4, 4, 8), (1, 1)), ("b", 0, 1, (4, 4, 8), (1, 1)),
         ("c", 1, 2, (4, 4, 8), (1, 1)), ("d", 2, 3, (4, 4, 8), (1, 1))],
        dict(same=[("c", "a"), ("d", "b")], slots=2)),
    # a dies AT node 0, which produces b: the producer zeroes its output
    # slot while still reading its inputs, so they must not share
    "death_at_birth_keeps_slot": (
        [("a", -1, 0, (4, 4, 8), (1, 1)), ("b", 0, 1, (4, 4, 8), (1, 1))],
        dict(differ=[("a", "b")], slots=2)),
    "slot_shapes_are_elementwise_max": (
        [("a", -1, 0, (8, 4, 2), (1, 1)), ("b", 1, 2, (2, 6, 4), (0, 0))],
        dict(shapes=((8, 6, 4),), bytes=4 * 8 * 6 * 4)),
    "rejects_out_of_birth_order": (
        [("a", 2, 3, (1, 1, 1), (0, 0)), ("b", 0, 1, (1, 1, 1), (0, 0))],
        dict(raises=True)),
    "rejects_death_before_birth": (
        [("a", 2, 1, (1, 1, 1), (0, 0))], dict(raises=True)),
}


@pytest.mark.parametrize("case", list(ARENA_CASES))
def test_plan_arena_cases(case):
    rows, want = ARENA_CASES[case]
    if want.get("raises"):
        with pytest.raises(ValueError):
            jsched.plan_arena(arena_values("jax", rows))
        with pytest.raises(ValueError):
            tsched.plan_arena(arena_values("torch", rows))
        return
    plan = tsched.plan_arena(arena_values("torch", rows))
    assert norm(plan) == norm(jsched.plan_arena(arena_values("jax", rows)))
    for a, b in want.get("same", []):
        assert plan.slot_of(a) == plan.slot_of(b)
    for a, b in want.get("differ", []):
        assert plan.slot_of(a) != plan.slot_of(b)
    if "slots" in want:
        assert len(plan.slot_shapes) == want["slots"]
    if "shapes" in want:
        assert plan.slot_shapes == want["shapes"]
        assert plan.slot_bytes_f32 == want["bytes"]


@pytest.mark.parametrize("seed", range(3))
def test_plan_arena_never_aliases_live_values_and_matches_jax(seed):
    rng = np.random.default_rng(seed)
    for _ in range(40):
        rows, birth = [], -1
        for i in range(int(rng.integers(1, 13))):
            birth = int(rng.integers(birth, birth + 3))
            death = int(rng.integers(birth, birth + 5))
            rows.append((f"v{i}", birth, death,
                         tuple(int(v) for v in rng.integers(1, 17, 3)),
                         (0, 0)))
        plan = tsched.plan_arena(arena_values("torch", rows))
        assert norm(plan) == norm(jsched.plan_arena(arena_values("jax",
                                                                 rows)))
        by_slot = {}
        for v, s in zip(plan.values, plan.slots):
            assert all(p.death < v.birth for p in by_slot.get(s, ()))
            by_slot.setdefault(s, []).append(v)
            assert all(a <= b for a, b in zip(v.shape, plan.slot_shapes[s]))


def test_validation_catches_corrupted_graph_table():
    _, _, gkps = lowered("torch", "identity_block", False)
    gkp = gkps["stem"]
    tsched.validate_graph_kernel(gkp)
    bad = np.array(gkp.operand_table())
    bad[-1, tsched.GOP_WOFF] = gkp.w_total   # window runs off the buffer
    with pytest.raises(ValueError):
        tsched.validate_graph_kernel(dataclasses.replace(
            gkp, table=tuple(map(tuple, bad))))
    with pytest.raises(ValueError):
        jsched.validate_graph_kernel(dataclasses.replace(
            lowered("jax", "identity_block", False)[2]["stem"],
            table=tuple(map(tuple, bad))))


# ---------------------------------------------------------------------------
# plain K2 == plain K1 node by node, plain K4 == plain K3 node by node
# ---------------------------------------------------------------------------

# (case, images): 3 images make a ragged batch for the blocks of 2
KERNEL_CASES = [("alexnet_b8", 2), ("alexnet_16mb", 2),
                ("alexnet_281_steps", 2), ("identity_block", 2),
                ("identity_block", 3), ("input_in_arena", 2)]


def node_by_node(gkp, x, params, launch):
    """The chain through the per-layer launcher, node after node; the
    last node's padded output."""
    env = {gkp.input_value: x}
    for i, spec in enumerate(gkp.nodes):
        kp = spec.kp
        l = kp.wave.program.layer
        res = env[spec.residual_value] if spec.residual_value else None
        y = launch(kp, env[spec.in_value], params[i], res)
        if i == len(gkp.nodes) - 1:
            return y
        env[spec.out_value] = y[:, :kp.out_h, :kp.out_w, :l.out_c]


def first_chain(case, quantized):
    return next(iter(lowered("torch", case, quantized)[2].values()))


@pytest.mark.parametrize("case,images", KERNEL_CASES)
def test_plain_k2_equals_plain_k1_node_by_node(case, images):
    gkp = first_chain(case, False)
    gen = torch.Generator().manual_seed(1)
    l0 = gkp.nodes[0].kp.wave.program.layer
    x = torch.randn((images, l0.in_h, l0.in_w, l0.in_c), generator=gen)
    weights = []
    for s in gkp.nodes:
        l = s.kp.wave.program.layer
        weights.append((torch.randn((l.kernel, l.kernel, l.in_c // l.groups,
                                     l.out_c), generator=gen) * 0.1,
                        torch.randn((l.out_c,), generator=gen) * 0.1))

    def launch(kp, xin, wb, res):
        xp, wp, bias = ops.pad_operands(kp, xin, *wb)
        rp = ops.pad_residual(kp, res) if res is not None else None
        return k1.wave_replay_raw(kp, xp, wp, bias, torch.as_tensor(
            kp.operand_table()), residual=rp)

    k2.reset_launch_count()
    xp = ops.pad_input(gkp.nodes[0].kp, x)
    wf, bf = k2.pack_graph_weights(gkp, weights)
    got = k2.wave_replay_graph_raw(gkp, xp, wf, bf, torch.as_tensor(
        gkp.operand_table()))
    assert k2.plain_count() == 1 and k2.launch_count() == 0
    want = node_by_node(gkp, x, weights, launch)
    kl = gkp.out_kp
    assert got.shape == (images, kl.out_h_pad, kl.out_w_pad, kl.out_c_pad)
    assert torch.equal(got, want)
    assert float(want.abs().max()) > 0.1
    # the public wrapper crops the same values
    y = k2.wave_replay_graph(gkp, x, weights)
    assert torch.equal(y, want[:, :kl.out_h, :kl.out_w,
                               :gkp.out_layer.out_c])


@pytest.mark.parametrize("case,images", KERNEL_CASES)
def test_plain_k4_equals_plain_k3_node_by_node(case, images):
    from repro_torch.core.quantization import requant_params
    gkp = first_chain(case, True)
    gen = torch.Generator().manual_seed(2)
    l0 = gkp.nodes[0].kp.wave.program.layer
    x = torch.randint(-127, 128, (images, l0.in_h, l0.in_w, l0.in_c),
                      generator=gen, dtype=torch.int8)
    qops, pres = [], []
    for s in gkp.nodes:
        l = s.kp.wave.program.layer
        fan = l.kernel ** 2 * (l.in_c // l.groups)
        wq = torch.randint(-127, 128, (l.kernel, l.kernel,
                                       l.in_c // l.groups, l.out_c),
                           generator=gen, dtype=torch.int8)
        bq = torch.randint(-3000, 3000, (l.out_c,), generator=gen,
                           dtype=torch.int32)
        ratio = (torch.rand((l.out_c,), generator=gen, dtype=torch.float64)
                 + 0.5) * 60 / (fan ** 0.5 * 5376)
        m, shift, pre = requant_params(ratio.numpy(), fan * 127 * 127 + 3000)
        qops.append((wq, bq, torch.as_tensor(m), torch.as_tensor(shift)))
        pres.append(pre)

    def launch(kp, xin, q_pre, res):
        args = ops_q.pad_operands_q(kp, xin, *q_pre[0])
        rp = ops_q.pad_residual_q(kp, res) if res is not None else None
        return k3.wave_replay_q_raw(kp, *args, torch.as_tensor(
            kp.operand_table()), pre_shift=q_pre[1], residual=rp)

    k4.reset_launch_count()
    xp = ops.pad_input(gkp.nodes[0].kp, x)
    flat = k4.pack_graph_operands_q(gkp, qops)
    got = k4.wave_replay_graph_q_raw(gkp, xp, *flat, torch.as_tensor(
        gkp.operand_table()), pre_shifts=pres, fan_chunks=[None] * len(pres))
    assert k4.plain_count() == 1 and k4.launch_count() == 0
    want = node_by_node(gkp, x, list(zip(qops, pres)), launch)
    assert got.dtype == torch.int8 and torch.equal(got, want)
    valid = want[:, :gkp.out_kp.out_h, :gkp.out_kp.out_w,
                 :gkp.out_layer.out_c]
    assert 0 < int((valid != 0).sum()) and int((valid.abs() < 127).sum()) > 0


def test_packed_flat_buffers_place_every_chunk_at_its_offset():
    """Padded output channels carry zero bias (fp32) and m=0/shift=31
    (int8); every step's chunk sits at the table's WOFF."""
    gkp = first_chain("alexnet_281_steps", True)
    gen = torch.Generator().manual_seed(3)
    qops = []
    for s in gkp.nodes:
        l = s.kp.wave.program.layer
        qops.append((torch.randint(-127, 128, (l.kernel, l.kernel,
                                               l.in_c // l.groups, l.out_c),
                                   generator=gen, dtype=torch.int8),
                     torch.ones(l.out_c, dtype=torch.int32),
                     torch.full((l.out_c,), 5, dtype=torch.int32),
                     torch.full((l.out_c,), 9, dtype=torch.int32)))
    wf, bf, mf, sf = k4.pack_graph_operands_q(gkp, qops)
    assert int(wf.numel()) == gkp.w_total
    for spec, boff, (wq, *_) in zip(gkp.nodes, gkp.b_offsets, qops):
        oc, pad = spec.kp.wave.program.layer.out_c, spec.kp.out_c_pad
        assert bool((mf[boff:boff + oc] == 5).all())
        assert bool((mf[boff + oc:boff + pad] == 0).all())
        assert bool((sf[boff + oc:boff + pad] == 31).all())
    tab = gkp.operand_table()
    for ni, spec in enumerate(gkp.nodes):
        kp = spec.kp
        wq = F_pad_q(kp, qops[ni][0])
        rows = tab[tab[:, tsched.GOP_NODE] == ni]
        for k in range(kp.n_chain):
            woff = int(rows[rows[:, tsched.GOP_K] == k][0, tsched.GOP_WOFF])
            chunk = wq[:, :, k * kp.fan_width:(k + 1) * kp.fan_width, :]
            assert torch.equal(wf[woff:woff + chunk.numel()],
                               chunk.reshape(-1))


def F_pad_q(kp, wq):
    g = kp.wave.program
    return torch.nn.functional.pad(
        wq, (0, g.out_c_pad - g.layer.out_c, 0, kp.w_in_kpad - wq.shape[2]))


# ---------------------------------------------------------------------------
# the graphkernel forward against the JAX package
# ---------------------------------------------------------------------------

def jax_pair(case):
    graph, sram, budget, batch = CASES[case]
    jg, jp = programs("jax", graph, sram)
    tg, tp = programs("torch", graph, sram)
    jw = jax_init(jg, jax.random.key(0))
    np_w = {n: (np.asarray(w), np.asarray(b)) for n, (w, b) in jw.items()}
    x = np.random.default_rng(4).standard_normal(
        (batch,) + tuple(tg.in_shape), np.float32)
    return jg, jp, jw, tg, tp, weights_from_numpy(tg, np_w, "cpu"), x


@pytest.mark.parametrize("case", ["identity_block", "input_in_arena",
                                  "alexnet_281_steps"])
def test_graphkernel_forward_matches_jax_wave_and_reference(case):
    jg, jp, jw, tg, tp, tw, x = jax_pair(case)
    _, sram, budget, batch = CASES[case]
    fwd = tstream.graph_forward_fn(tg, tp, "graphkernel", budget,
                                   batch=batch)
    table = tstream.graph_operands(tg, tp, "graphkernel", budget,
                                   batch=batch, device="cpu")
    k1.reset_launch_count()
    k2.reset_launch_count()
    y = fwd(torch.as_tensor(x), tw, table)
    assert k2.plain_count() == len(table) and k1.plain_count() == 0
    ref = np.asarray(jstream.run_graph_reference(
        jg, jw, jnp.asarray(x))[jg.output])
    err, tol = fp32_error(y, ref)
    assert err <= tol and np.abs(ref).max() > 0.1
    wave = np.asarray(jstream.run_graph_streamed(
        jg, jstream.plan_graph(jg, sram), jnp.asarray(x), jw, mode="wave"))
    err, tol = fp32_error(y, wave)
    assert err <= tol


@pytest.mark.parametrize("case", ["identity_block", "input_in_arena"])
def test_graphkernel_int8_equals_jax_int32_walk(case):
    jg, jp, jw, tg, tp, tw, x = jax_pair(case)
    _, _, budget, batch = CASES[case]
    calib = np.random.default_rng(9).standard_normal(
        (2,) + tuple(tg.in_shape), np.float32)
    jqg = jax_calibrate(jg, jw, jnp.asarray(calib))
    qg = quantized_graph_from_numpy(tg, jqg.quants, jqg.scales)
    fwd = tstream.graph_forward_fn(tg, tp, "graphkernel", budget,
                                   precision="int8", qgraph=qg,
                                   dequantize=False, batch=batch)
    table = tstream.graph_operands(tg, tp, "graphkernel", budget,
                                   precision="int8", batch=batch,
                                   device="cpu")
    k3.reset_launch_count()
    k4.reset_launch_count()
    got = fwd(torch.as_tensor(x), qg.device_weights("cpu"), table)
    assert k4.plain_count() == 1 and k3.plain_count() == 0
    want = np.asarray(jax_quant_acts(jqg, jnp.asarray(x))[jg.output])
    assert got.dtype == torch.int8
    np.testing.assert_array_equal(got.numpy(), want)
    assert np.count_nonzero(want) > 0.05 * want.size


# ---------------------------------------------------------------------------
# the launcher's checks, the launch plan and the build
# ---------------------------------------------------------------------------

def test_launchers_check_shapes_dtypes_and_devices():
    gkp = first_chain("identity_block", False)
    h0 = gkp.nodes[0].kp
    x = torch.zeros((2, h0.pad_h, h0.pad_w, h0.in_c_kpad))
    wf = torch.zeros(gkp.w_total)
    bf = torch.zeros(gkp.b_total)
    tab = torch.as_tensor(gkp.operand_table())
    with pytest.raises(ValueError, match="padded"):
        k2.wave_replay_graph_raw(gkp, x[:, 1:], wf, bf, tab)
    with pytest.raises(ValueError, match="flat weights"):
        k2.wave_replay_graph_raw(gkp, x, wf[1:], bf, tab)
    with pytest.raises(ValueError, match="graph table"):
        k2.wave_replay_graph_raw(gkp, x, wf, bf, tab[1:])
    with pytest.raises(ValueError, match="float32"):
        k2.wave_replay_graph_raw(gkp, x.double(), wf, bf, tab)
    with pytest.raises(ValueError, match="contiguous"):
        k2.wave_replay_graph_raw(gkp, x, torch.zeros(2 * gkp.w_total)[::2],
                                 bf, tab)
    with pytest.raises(ValueError, match="cuda"):
        k2.wave_replay_graph_raw(gkp, x.to("meta"), wf.to("meta"),
                                 bf.to("meta"), tab.to("meta"))
    with pytest.raises(ValueError, match="quantized=True"):
        k4.wave_replay_graph_q_raw(gkp, x.to(torch.int8),
                                   wf.to(torch.int8), bf.int(), bf.int(),
                                   bf.int(), tab, pre_shifts=[0] * 3,
                                   fan_chunks=[None] * 3)
    gq = first_chain("identity_block", True)
    args = (x.to(torch.int8), wf.to(torch.int8), bf.int(), bf.int(),
            bf.int(), tab)
    with pytest.raises(ValueError, match="one entry per"):
        k4.wave_replay_graph_q_raw(gq, *args, pre_shifts=[0],
                                   fan_chunks=[None])
    with pytest.raises(ValueError, match="pre_shift"):
        k4.wave_replay_graph_q_raw(gq, *args, pre_shifts=[0, 40, 0],
                                   fan_chunks=[None] * 3)
    with pytest.raises(ValueError, match="int8"):
        k4.wave_replay_graph_q_raw(gq, x, *args[1:], pre_shifts=[0] * 3,
                                   fan_chunks=[None] * 3)


def struct_ints(src, name, sizes):
    """Count the ints of ``struct <name>`` in a CUDA source, nested
    structs by ``sizes``."""
    body = re.search(r"struct %s \{(.*?)\};" % name, src, re.S).group(1)
    n = 0
    for decl in body.split(";"):
        decl = re.sub(r"//.*", "", decl).strip()
        if not decl:
            continue
        typ, names = decl.split(None, 1)
        n += sizes.get(typ, 1) * len(names.split(","))
    return n


def test_node_descriptors_match_the_cuda_structs():
    sizes = {"int": 1, "Geom": len(k1.GEOM_FIELDS),
             "GeomQ": len(k3.GEOM_Q_FIELDS), "View": len(k2.VIEW_FIELDS)}
    body = (_build.CSRC / "wave_replay_body.cuh").read_text()
    assert struct_ints(body, "Geom", sizes) == len(k1.GEOM_FIELDS)
    assert struct_ints(body, "View", sizes) == len(k2.VIEW_FIELDS)
    qbody = (_build.CSRC / "wave_replay_q_body.cuh").read_text()
    assert struct_ints(qbody, "GeomQ", sizes) == len(k3.GEOM_Q_FIELDS)
    g = (_build.CSRC / "wave_replay_graph.cu").read_text()
    gq = (_build.CSRC / "wave_replay_graph_q.cu").read_text()
    assert struct_ints(g, "Node", sizes) == len(k2.NODE_FIELDS)
    assert struct_ints(gq, "NodeQ", sizes) == \
        len(k3.GEOM_Q_FIELDS) + len(k2.NODE_TAIL_FIELDS)
    assert struct_ints(g, "Stage", sizes) == len(k2.STAGE_FIELDS)


@pytest.mark.parametrize("case", ["alexnet_b8", "input_in_arena"])
def test_launch_plan_lays_out_the_arena_and_the_nodes(case):
    gkp = first_chain(case, True)
    batch = 8
    plan = k2.launch_plan(gkp, batch, k4._geom_q([0] * len(gkp.nodes),
                                                 True))
    f = {n: i for i, n in enumerate(k3.GEOM_Q_FIELDS
                                    + k2.NODE_TAIL_FIELDS)}
    rows = plan.nodes
    assert rows.shape == (len(gkp.nodes), len(f))
    offs, total = k2.slot_offsets(gkp, batch)
    assert total == plan.arena_elems
    assert all(o % k2.SLOT_ALIGN == 0 for o in offs)
    for ni, spec in enumerate(gkp.nodes):
        r = rows[ni]
        kp = spec.kp
        last = ni == len(gkp.nodes) - 1
        assert r[f["out_off"]] == (-1 if last else
                                   offs[gkp.arena.slot_of(spec.out_value)])
        if not last:
            h, w, c = gkp.arena.slot_shapes[gkp.arena.slot_of(
                spec.out_value)]
            assert r[f["zero_elems"]] == batch * h * w * c
            assert r[f["ov_wc"]] == min(kp.out_c_pad, c)
        windowed = ni == 0 and not gkp.input_in_arena
        assert (r[f["in_off"]] == -1) == windowed
        assert r[f["w_in"]] == kp.fan_width
        assert r[f["step0"]] == gkp.node_steps[ni]
        assert r[f["boff"]] == gkp.b_offsets[ni]
        # a word of A is one load only where the slot's channel stride,
        # the fan and every channel origin are multiples of 4
        assert r[f["vec_x"]] == int(kp.fan_width % 4 == 0
                                    and r[f["in_c"]] % 4 == 0)
    assert (plan.stage[0] >= 0) == gkp.input_in_arena
    if case == "alexnet_b8":      # conv1's 3 channels: byte gathers
        assert rows[0][f["vec_x"]] == 0 and rows[1][f["vec_x"]] == 1


def test_build_target_hashes_shared_headers(tmp_path, monkeypatch):
    (tmp_path / "k.cu").write_text('#include "h.cuh"\n')
    (tmp_path / "h.cuh").write_text("// v1\n")
    monkeypatch.setattr(_build, "CSRC", tmp_path)
    a = _build._target("k")
    assert _build._target("k") == a
    (tmp_path / "h.cuh").write_text("// v2\n")
    assert _build._target("k") != a
