"""The port's planner and lowering give exactly the JAX package's plans,
kernel-program geometry and operand tables, for every zoo graph, at the
default budget and at the paper's 128 KB plans (``vmem_budget=None``),
for batches 1, 3 and 8. The MobileNets run in
test_torch_schedule_mobilenet.py with the checks defined here, so that
parallel test workers share the work.

At the default budget both packages re-plan each conv node by lowering
some 250 candidate programs (``plan_for_vmem``), one to two seconds per
node and batch on a CPU core. So there the check covers every node of
AlexNet and a fixed sample of each other graph — its first and last conv
and its first grouped and first residual-fused conv — while the 1:1
lowering (``vmem_budget=None``) is checked on every node of every graph.
"""
import dataclasses
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core import model_zoo as jzoo  # noqa: E402
from repro.core import streaming as jstream  # noqa: E402
from repro_torch.core import model_zoo as tzoo  # noqa: E402
from repro_torch.core import schedule as tsched  # noqa: E402
from repro_torch.core import streaming as tstream  # noqa: E402

# AlexNet at its nameplate size; the others reduced
GRAPHS = {
    "alexnet": {},
    "vgg16": dict(in_hw=32, width=8),
    "resnet18": dict(in_hw=32, width=8),
    "facedet": {},
    "mobilenet_v1": dict(in_hw=32, width=8),
    "mobilenet_v2": dict(in_hw=32, width=8),
}


def norm(v):
    """Dataclasses (ConvLayer, Plan) are distinct types in the two
    packages; compare them by class name and fields."""
    if dataclasses.is_dataclass(v) and not isinstance(v, type):
        return (type(v).__name__,
                tuple(norm(getattr(v, f.name))
                      for f in dataclasses.fields(v)))
    if isinstance(v, (tuple, list)):
        return tuple(norm(x) for x in v)
    return v


@functools.lru_cache(maxsize=None)
def lowered(name):
    jg = jzoo.network_graph(name, **GRAPHS[name])
    tg = tzoo.network_graph(name, **GRAPHS[name])
    jplans, tplans = jstream.plan_graph(jg), tstream.plan_graph(tg)
    return (jg, jstream.compile_graph(jg, jplans), jplans,
            tg, tstream.compile_graph(tg, tplans), tplans)


def check_graph_and_plans(name):
    jg, jprogs, jplans, tg, tprogs, tplans = lowered(name)
    assert norm(tg.nodes) == norm(jg.nodes)
    assert tg.in_shape == jg.in_shape and tg.output == jg.output
    assert list(tplans) == list(jplans)
    for n in jplans:
        assert norm(tplans[n]) == norm(jplans[n])
        assert norm(tprogs[n].geometry) == norm(jprogs[n].geometry)
        np.testing.assert_array_equal(tprogs[n].operands(),
                                      jprogs[n].operands())
    assert norm(tstream._graph_epilogues(tg)) == \
        norm(jstream._graph_epilogues(jg))


def sampled_nodes(g):
    convs = g.conv_nodes()
    fused = tstream._graph_epilogues(g)
    picks = [convs[0].name, convs[-1].name]
    picks += [n.name for n in convs if n.layer.groups > 1][:1]
    picks += [n for n in fused if fused[n][1] is not None][:1]
    return sorted(set(picks))


def check_kernel_programs(name, budget, batch):
    jg, jprogs, _, tg, tprogs, _ = lowered(name)
    vb = tsched.DEFAULT_VMEM_BUDGET if budget == "default" else None
    nodes = sampled_nodes(tg) if vb and name != "alexnet" else list(tprogs)
    jepi, tepi = jstream._graph_epilogues(jg), tstream._graph_epilogues(tg)
    for n in nodes:
        jk = jstream._graph_kernel_program(
            jprogs[n], jepi[n][0], jepi[n][1] is not None, vb, batch)
        tk = tstream._graph_kernel_program(
            tprogs[n], tepi[n][0], tepi[n][1] is not None, vb, batch)
        assert norm(tk.geometry) == norm(jk.geometry), n
        assert tk.vmem_bytes == jk.vmem_bytes
        np.testing.assert_array_equal(tk.operand_table(),
                                      jk.operand_table())


NAMES = ["alexnet", "facedet", "resnet18", "vgg16"]


@pytest.mark.parametrize("name", NAMES)
def test_graphs_and_plans_match(name):
    check_graph_and_plans(name)


@pytest.mark.parametrize("batch", [1, 3, 8])
@pytest.mark.parametrize("budget", ["default", None])
@pytest.mark.parametrize("name", NAMES)
def test_kernel_programs_and_tables_match(name, budget, batch):
    check_kernel_programs(name, budget, batch)


def test_graph_operands_are_the_reference_tables_on_the_device():
    jg, jprogs, _, tg, tprogs, _ = lowered("alexnet")
    jk = jstream.graph_kernel_programs(jg, jprogs, batch=8)
    ops = tstream.graph_operands(tg, tprogs, "megakernel", batch=8,
                                 device="cpu")
    assert list(ops) == list(jk)
    for n, kp in jk.items():
        assert ops[n].dtype == torch.int32 and ops[n].device.type == "cpu"
        np.testing.assert_array_equal(ops[n].numpy(), kp.operand_table())


def test_paper_budget_gives_multi_step_chains():
    """``vmem_budget=None`` replays the 128 KB plans 1:1: AlexNet conv3
    then runs a 256-step partial-sum chain and conv1 a 7-tile grid."""
    _, _, _, tg, tprogs, _ = lowered("alexnet")
    kps = tstream.graph_kernel_programs(tg, tprogs, None, 8)
    assert kps["conv3"].n_chain == 256
    assert kps["conv1"].n_tiles == 7
