"""The port's elastic sampler and dataloader (``elastic/{sampler,
dataloader}.py``) against the JAX package's, on the CPU. Every
comparison is exact: the same index streams, element for element.

The sampler cases are those of ``tests/test_elastic.py``, merged as one
parametrised test: each scenario runs every rank of a first world, the
same number of whole batches recorded, the state saved, and every rank
of a second world (another size, another seed) loaded from it; with the
partition (100 samples over 4), the resume at a different world, the
ten fuzz trials, the short tail, the 48 mid-epoch evictions (every
``drop_last`` × ``shuffle``) and two later epochs.
"""

import json
import os

import numpy as np
import pytest

pytest.importorskip("jax")

from dlrover_tpu.elastic.dataloader import (  # noqa: E402
    ElasticDataLoader as JLoader,
)
from dlrover_tpu.elastic.sampler import (  # noqa: E402
    ElasticDistributedSampler as JSampler,
)
from dlrover_tpu_torch.elastic.dataloader import ElasticDataLoader  # noqa
from dlrover_tpu_torch.elastic.sampler import (  # noqa: E402
    ElasticDistributedSampler,
)


def _scenarios():
    out = [
        # partition: 100 samples over 4 ranks, no resume
        dict(n=100, w1=4, bs=0, steps=0, w2=0, shuffle=True, seed=7),
        # 4 ranks consume 2 steps of 4 a rank, resume at 2
        dict(n=64, w1=4, bs=4, steps=2, w2=2, shuffle=True, seed=0),
        # the short tail: 10 samples, 9 done, 4 ranks
        dict(n=10, w1=4, bs=3, steps=3, w2=4, shuffle=False, seed=0,
             completed=9),
        # later epochs
        dict(n=50, w1=3, bs=2, steps=4, w2=2, shuffle=True, seed=5,
             epoch=1),
        dict(n=50, w1=3, bs=2, steps=4, w2=5, shuffle=True, seed=5,
             epoch=2, drop_last=True),
    ]
    rng = np.random.RandomState(3)  # the resume fuzz's trials
    for trial in range(10):
        n = int(rng.randint(40, 200))
        world = int(rng.choice([1, 2, 4, 8]))
        per_rank = len(list(JSampler(n, world, 0, True, trial)))
        bs = int(rng.randint(1, 8))
        steps = int(rng.randint(0, max(1, per_rank // bs)))
        out.append(dict(n=n, w1=world, bs=bs, steps=steps,
                        w2=int(rng.choice([1, 2, 4])), shuffle=True,
                        seed=trial))
    for drop_last in (False, True):  # the mid-epoch evictions
        for shuffle in (False, True):
            rng = np.random.RandomState(11)
            for _ in range(12):
                n = int(rng.randint(50, 300))
                r1 = int(rng.choice([4, 6, 8]))
                r2 = int(rng.choice([2, 3, 4, 6]))
                bs = int(rng.randint(1, 5))
                steps = int(rng.randint(1, max(2, n // (bs * r1))))
                out.append(dict(n=n, w1=r1, bs=bs, steps=steps, w2=r2,
                                shuffle=shuffle, seed=7, seed2=0,
                                drop_last=drop_last))
    return out


SCENARIOS = _scenarios()


def _run(cls, sc):
    """Every rank's stream and length in the first world, the saved state,
    and every rank's stream and length in the second."""
    drop = sc.get("drop_last", False)
    first = [cls(sc["n"], num_replicas=sc["w1"], rank=r,
                 shuffle=sc["shuffle"], seed=sc["seed"], drop_last=drop)
             for r in range(sc["w1"])]
    for s in first:
        if sc.get("epoch"):
            s.set_epoch(sc["epoch"])
    got = {"first": [(list(s), len(s)) for s in first]}
    for s in first:
        for _ in range(sc["steps"]):
            s.record_batch(sc["bs"])
    state = first[0].state_dict()
    if "completed" in sc:
        state = dict(state, completed=sc["completed"])
    got["state"] = state
    if sc["w2"]:
        second = [cls(sc["n"], num_replicas=sc["w2"], rank=r,
                      shuffle=sc["shuffle"], seed=sc.get("seed2", sc["seed"]),
                      drop_last=drop) for r in range(sc["w2"])]
        for s in second:
            s.load_state_dict(state)
        got["second"] = [(list(s), len(s), s.state_dict()) for s in second]
    return got


@pytest.mark.parametrize("sc", SCENARIOS,
                         ids=[f"case{i}" for i in range(len(SCENARIOS))])
def test_the_sampler_streams_equal_jax(sc):
    assert _run(ElasticDistributedSampler, sc) == _run(JSampler, sc)


def test_a_rank_beyond_the_world_is_refused_by_both():
    for cls in (ElasticDistributedSampler, JSampler):
        with pytest.raises(ValueError):
            cls(10, num_replicas=2, rank=2)


def _fetch(indices):
    return {"x": np.asarray(indices) * 10 + 1}


def _batches(loader_cls, sampler_cls, path, bump=None):
    sampler = sampler_cls(48, num_replicas=2, rank=1, shuffle=True, seed=3)
    loader = loader_cls(_fetch, sampler=sampler, batch_size=4,
                        config_path=path, drop_last=False)
    out = []
    for i, b in enumerate(loader):
        out.append((b["x"].tolist(), sampler.completed, loader.batch_size))
        if bump and i == bump[0]:  # a new config version mid-epoch
            with open(path, "w") as f:
                json.dump({"version": 2, "batch_size": bump[1]}, f)
    return out


def test_the_loader_over_a_sampler_and_its_reload_equal_jax(tmp_path):
    path = str(tmp_path / "paral.json")
    with open(path, "w") as f:
        json.dump({"version": 1, "batch_size": 6}, f)
    want = _batches(JLoader, JSampler, path, bump=(1, 5))
    with open(path, "w") as f:
        json.dump({"version": 1, "batch_size": 6}, f)
    got = _batches(ElasticDataLoader, ElasticDistributedSampler, path,
                   bump=(1, 5))
    assert got == want
    assert [n for _, _, n in got][:3] == [6, 6, 5]  # reloaded mid-epoch


def test_the_loader_reads_the_config_path_from_the_environment(
        tmp_path, monkeypatch):
    path = tmp_path / "paral.json"
    path.write_text('{"version": 3, "batch_size": 8}')
    monkeypatch.setenv("DLROVER_TPU_PARAL_CONFIG", str(path))
    for loader_cls, sampler_cls in ((ElasticDataLoader,
                                     ElasticDistributedSampler),
                                    (JLoader, JSampler)):
        loader = loader_cls(_fetch, sampler=sampler_cls(64, shuffle=False),
                            batch_size=4)
        assert loader.config_path == str(path)
        batches = list(loader)
        assert len(batches) == 8 and all(len(b["x"]) == 8 for b in batches)


class _Shards:
    """A sharding client's ``iter_shards``: (start, end, record indices)."""

    def iter_shards(self):
        yield 0, 10, []
        yield 10, 20, [19, 11, 15, 13, 12, 18, 14, 10, 16, 17]
        yield 20, 23, []


@pytest.mark.parametrize("drop_last", [True, False])
def test_the_loader_over_master_shards_equals_jax(drop_last):
    runs = [[b["x"].tolist() for b in cls(_fetch, sharding_client=_Shards(),
                                          batch_size=4, drop_last=drop_last)]
            for cls in (ElasticDataLoader, JLoader)]
    assert runs[0] == runs[1]
    with pytest.raises(ValueError):
        ElasticDataLoader(_fetch)
    with pytest.raises(ValueError):
        ElasticDataLoader(_fetch, sampler=ElasticDistributedSampler(4),
                          sharding_client=_Shards())


def test_no_config_file_keeps_the_batch_size(tmp_path):
    loader = ElasticDataLoader(_fetch, sampler=ElasticDistributedSampler(8),
                               batch_size=2,
                               config_path=str(tmp_path / "absent.json"))
    assert loader.batch_size == 2 and not os.path.exists(loader.config_path)
    assert [len(b["x"]) for b in loader] == [2, 2, 2, 2]
