"""Minibatch sampling, the data pipelines and the bucket helpers against
the JAX package: on the same numpy-seeded graph and generator, each
equals the reference's bit for bit (draws, compacted ids, union blocks,
batches and pipeline state)."""

import numpy as np
import pytest
import torch

from repro import config as jconfig
from repro.configs import granite_3_8b as jgranite
from repro.data.pipeline import GraphPipeline as JGraphPipeline
from repro.data.pipeline import TokenPipeline as JTokenPipeline
from repro.graph.datasets import make_synthetic_graph as jgraph
from repro.graph.sampling import sample_neighbors as jsample
from repro.graph.sampling import two_hop_batch as jtwo_hop
from repro.serve import graph_engine as jengine
from repro_torch import config as tconfig
from repro_torch.configs import granite_3_8b as tgranite
from repro_torch.data.pipeline import GraphPipeline, TokenPipeline
from repro_torch.graph.datasets import make_synthetic_graph as tgraph
from repro_torch.graph.sampling import sample_neighbors, two_hop_batch
from repro_torch.serve import graph_engine as tengine

torch.set_num_threads(2)

#: reduced Cora (V=512, E=1026) and reduced Reddit (V=999, E=49822):
#: degrees below and far above the fanouts
SPECS = {"cora": 512, "reddit": 1000}


def _graphs(name):
    base = {"cora": (jconfig.CORA, tconfig.CORA),
            "reddit": (jconfig.REDDIT, tconfig.REDDIT)}[name]
    jspec = jconfig.reduced_graph(base[0], SPECS[name], 16)
    tspec = tconfig.reduced_graph(base[1], SPECS[name], 16)
    return jspec, tspec, jgraph(jspec), tgraph(tspec, device="cpu")


def _same_graph(jg, tg):
    np.testing.assert_array_equal(np.asarray(jg.src), tg.src.numpy())
    np.testing.assert_array_equal(np.asarray(jg.dst), tg.dst.numpy())
    np.testing.assert_array_equal(np.asarray(jg.in_deg), tg.in_deg.numpy())
    assert jg.num_vertices == tg.num_vertices


def _same_block(jb, tb):
    _same_graph(jb.graph, tb.graph)
    assert jb.real_edges == tb.real_edges
    np.testing.assert_array_equal(jb.seed_ids, tb.seed_ids)
    np.testing.assert_array_equal(jb.input_ids, tb.input_ids)


@pytest.mark.parametrize("name", list(SPECS))
@pytest.mark.parametrize("fanout", [1, 4, 25])
def test_sample_neighbors_bitwise(name, fanout):
    jspec, _, jg, tg = _graphs(name)
    seeds = np.random.default_rng(5).choice(jspec.num_vertices, 40,
                                            replace=False).astype(np.int32)
    jb = jsample(jg, seeds, fanout, np.random.default_rng(9))
    tb = sample_neighbors(tg, seeds, fanout, np.random.default_rng(9),
                          device="cpu")
    _same_block(jb, tb)
    assert tb.graph.num_edges == len(seeds) * fanout


@pytest.mark.parametrize("name", list(SPECS))
def test_two_hop_batch_bitwise(name):
    jspec, _, jg, tg = _graphs(name)
    seeds = np.arange(0, jspec.num_vertices, 37, dtype=np.int32)
    for fanouts in ((2, 3), (25, 10)):
        for j, t in zip(jtwo_hop(jg, seeds, fanouts, seed=4),
                        two_hop_batch(tg, seeds, fanouts, seed=4,
                                      device="cpu")):
            _same_block(j, t)
    # one long-lived generator: fresh draws per call, the reference's
    jr, tr = np.random.default_rng(11), np.random.default_rng(11)
    for _ in range(2):
        for j, t in zip(jtwo_hop(jg, seeds, (3, 3), rng=jr),
                        two_hop_batch(tg, seeds, (3, 3), rng=tr,
                                      device="cpu")):
            _same_block(j, t)


def test_graph_pipeline_batches_and_state():
    jspec, tspec, jg, tg = _graphs("reddit")
    jp = JGraphPipeline(jg, jspec, 16, fanouts=(4, 3), seed=2)
    tp = GraphPipeline(tg, tspec, 16, fanouts=(4, 3), seed=2, device="cpu")
    for step in (0, 3, 7):
        jb, tb = jp.batch_at(step), tp.batch_at(step)
        np.testing.assert_array_equal(jb["seeds"], tb["seeds"])
        _same_block(jb["hop1"], tb["hop1"])
        _same_block(jb["hop2"], tb["hop2"])
    it = iter(tp)
    first, second = next(it), next(it)
    np.testing.assert_array_equal(first["seeds"], jp.batch_at(0)["seeds"])
    np.testing.assert_array_equal(second["seeds"], jp.batch_at(1)["seeds"])
    assert tp.state_dict() == {"step": 2, "seed": 2}
    other = GraphPipeline(tg, tspec, 16, fanouts=(4, 3), seed=0,
                          device="cpu")
    other.load_state_dict(tp.state_dict())
    np.testing.assert_array_equal(next(iter(other))["seeds"],
                                  jp.batch_at(2)["seeds"])


def test_token_pipeline_bitwise():
    jshape = jconfig.ShapeSpec("tiny", 16, 4, "train")
    tshape = tconfig.ShapeSpec("tiny", 16, 4, "train")
    jp = JTokenPipeline(jgranite.reduced(), jshape, seed=1,
                        frontend_tokens=4)
    tp = TokenPipeline(tgranite.reduced(), tshape, seed=1, frontend_tokens=4)
    for step in (0, 5):
        jb, tb = jp.batch_at(step), tp.batch_at(step)
        assert sorted(jb) == sorted(tb)
        for k in jb:
            np.testing.assert_array_equal(np.asarray(jb[k]), tb[k])
    next(iter(tp))
    assert tp.state_dict() == {"step": 1, "seed": 1}
    tp.load_state_dict({"step": 5, "seed": 1})
    np.testing.assert_array_equal(next(iter(tp))["tokens"],
                                  jp.batch_at(5)["tokens"])
    with pytest.raises(ValueError):
        tconfig.ShapeSpec("bad", 16, 4, "serve")


@pytest.mark.parametrize("fanouts,levels,cap", [
    ((5, 5), (4, 16, 64), None), ((25, 10), (512,), 232965),
    ((3, 3), (8,), 300)])
def test_default_buckets_and_fits(fanouts, levels, cap):
    jb = jengine.default_buckets(fanouts, seed_levels=levels, max_inputs=cap)
    tb = tengine.default_buckets(fanouts, seed_levels=levels, max_inputs=cap)
    assert [tuple(b) for b in jb] == [tuple(b) for b in tb]
    b = tb[-1]
    for args in ((b.num_seeds, b.num_inputs - 1, b.num_edges - 1),
                 (b.num_seeds, b.num_inputs, b.num_edges - 1),
                 (b.num_seeds, b.num_inputs, b.num_edges),
                 (b.num_seeds + 1, 1, 1), (1, 1, b.num_edges + 1)):
        assert jb[-1].fits(*args) == b.fits(*args)


@pytest.mark.parametrize("name", list(SPECS))
def test_union_two_hop_bitwise(name):
    jspec, _, jg, tg = _graphs(name)
    seeds = np.random.default_rng(3).choice(jspec.num_vertices, 12,
                                            replace=False).astype(np.int32)
    jh2, jh1 = jtwo_hop(jg, seeds, (4, 3), seed=8)
    th2, th1 = two_hop_batch(tg, seeds, (4, 3), seed=8, device="cpu")
    jf, jug, jpos = jengine.union_two_hop(jh2, jh1, seeds)
    tf, tug, tpos = tengine.union_two_hop(th2, th1, seeds, device="cpu")
    np.testing.assert_array_equal(jf, tf)
    np.testing.assert_array_equal(np.asarray(jpos), tpos)
    _same_graph(jug, tug)
    np.testing.assert_array_equal(
        tengine._index_of(tf, seeds), np.asarray(jengine._index_of(jf, seeds)))
    with pytest.raises(ValueError, match="cover"):
        tengine._index_of(tf, np.array([jspec.num_vertices + 5]))
