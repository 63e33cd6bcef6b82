"""The port's loader with worker threads and rank shards, on the CPU.

The three readers (ScanNet in ``recon_random`` mode, which draws frames,
a rotation and a translation; ARKit; the stage-2 points, one dump shorter
than ``num_points``) give, over two shuffled epochs:
- with 4 workers the one-worker samples, bit for bit, in the same order;
- on each rank of W = 2 and W = 4 its positions ``r, r + W, ...`` of the
  one-process epoch, disjoint, the last incomplete round dropped, each
  sample bit-equal to the one-process sample of that scene.

A sample is held by a hash of its arrays and its scene and frame ids.  A
worker's exception comes out at its scene's place in the order, and 4
workers hold at most 5 samples.  The existing port-against-JAX reader
tests (``test_torch_test_cli.py``, ``test_torch_stages.py``,
``test_torch_arkit.py``) hold the one-worker samples against JAX.
"""

import hashlib
import os
import threading
import weakref

import numpy as np
import pytest

from cnrma_torch.data.arkit import AtlasARKitDataset
from cnrma_torch.data.loader import SceneLoader
from cnrma_torch.data.points_dataset import MiddlePointsDataset
from cnrma_torch.data.scannet import AtlasScanNetDataset
from cnrma_torch.synthetic import write_arkit, write_point_dumps, write_scannet

N_SCENES = 5
SEED = 7            # the loader's shuffle
EPOCHS = 2


@pytest.fixture(scope="module")
def readers(tmp_path_factory):
    """name -> a maker of a fresh reader (seed 3) of 5 tiny scenes."""
    root = str(tmp_path_factory.mktemp("loader"))
    scannet = os.path.join(root, "scannet")
    ann = write_scannet(scannet, n_scenes=N_SCENES, n_frames=6,
                        tsdf_dim=(24, 24, 12), image_size=(64, 48),
                        ann_name="scannet_infos_train.pkl")
    arkit = os.path.join(root, "arkit")
    ark_ann = write_arkit(arkit, n_scenes=N_SCENES, n_frames=6,
                          tsdf_dim=(24, 24, 16), image_size=(64, 48))
    dumps = os.path.join(root, "dumps")
    write_point_dumps(scannet, dumps, n_points=600, seed=4)
    short = os.path.join(dumps, "scene0001_00_vert.npy")
    np.save(short, np.load(short)[:300])        # fewer points than p
    recon = dict(random_rotation=True, random_translation=True,
                 padding_xy=1.5, padding_z=0.25)
    return {
        "scannet_recon_random": lambda: AtlasScanNetDataset(
            data_root=scannet, ann_file=ann, num_frames=3,
            voxel_dim=(16, 16, 8), space_mode="recon_random",
            image_size=(32, 32), seed=3, recon_pipeline=recon),
        "arkit": lambda: AtlasARKitDataset(
            data_root=arkit, ann_file=ark_ann, num_frames=3,
            voxel_dim=(16, 16, 16), image_size=(32, 32), seed=3,
            space_mode="middle"),
        "points": lambda: MiddlePointsDataset(
            data_root=scannet, ann_file=ann, points_dir=dumps,
            num_points=500, seed=3),
    }


def _digest(batch) -> str:
    h = hashlib.sha256()
    for key in sorted(batch):
        if key in ("load_s", "wait_s"):
            continue
        value = batch[key]
        if key == "tsdf_list":
            for k in sorted(value):
                h.update(k.encode())
                h.update(np.ascontiguousarray(value[k]).tobytes())
        elif isinstance(value, np.ndarray):
            h.update(key.encode() + str(value.dtype).encode())
            h.update(np.ascontiguousarray(value).tobytes())
        else:
            h.update(f"{key}={value!r}".encode())
    return h.hexdigest()


def _epochs(loader):
    return [[(b["index"], _digest(b)) for b in loader]
            for _ in range(EPOCHS)]


@pytest.mark.parametrize("name", ["scannet_recon_random", "arkit",
                                  "points"])
def test_workers_and_ranks_give_the_one_thread_samples(readers, name):
    make = readers[name]
    want = _epochs(SceneLoader(make(), seed=SEED, num_workers=1))
    assert all(sorted(i for i, _ in e) == list(range(N_SCENES))
               for e in want)
    assert [i for i, _ in want[0]] != [i for i, _ in want[1]]
    # the draws move the samples: a scene's sample changes between epochs
    assert len({d for e in want for _, d in e}) > N_SCENES
    assert _epochs(SceneLoader(make(), seed=SEED, num_workers=4)) == want
    for world in (2, 4):
        kept = N_SCENES // world * world
        shares = []
        for rank in range(world):
            loader = SceneLoader(make(), seed=SEED, num_workers=4,
                                 rank=rank, world_size=world)
            assert len(loader) == N_SCENES // world
            got = _epochs(loader)
            for epoch in range(EPOCHS):
                assert got[epoch] == want[epoch][rank:kept:world], \
                    (world, rank, epoch)
            shares.append([i for i, _ in got[0]])
        flat = [i for s in shares for i in s]
        assert len(flat) == len(set(flat)) == kept
        dropped = set(range(N_SCENES)) - set(flat)
        assert dropped == {i for i, _ in want[0][kept:]}


def test_ranks_without_drop_share_every_scene(readers):
    """The val and test splits' shards: every scene once over the ranks,
    in the dataset's order, each equal to the one-process sample."""
    make = readers["scannet_recon_random"]
    want = _epochs(SceneLoader(make(), shuffle=False))
    assert [i for i, _ in want[0]] == list(range(N_SCENES))
    for world in (2, 4):
        seen = []
        for rank in range(world):
            loader = SceneLoader(make(), shuffle=False, num_workers=2,
                                 rank=rank, world_size=world,
                                 drop_last=False)
            got = _epochs(loader)
            assert len(loader) == len(got[0])
            assert got == [e[rank::world] for e in want]
            seen += [i for i, _ in got[0]]
        assert sorted(seen) == list(range(N_SCENES))


class _Failing:
    """Scenes 0..n-1 of which ``load`` (or ``draw``) of scene ``bad``
    raises; every other load waits a little, so that the workers run
    ahead of the failure."""

    def __init__(self, n, bad, where="load"):
        self.n, self.bad, self.where = n, bad, where

    def __len__(self):
        return self.n

    def draw(self, i):
        if self.where == "draw" and i == self.bad:
            raise ValueError(f"draw {i}")
        return {"i": i}

    def load(self, i, draws):
        assert draws["i"] == i
        if self.where == "load" and i == self.bad:
            raise ValueError(f"load {i}")
        threading.Event().wait(0.01)
        return {"scene": f"s{i}", "imgs": np.full((2,), i, np.float32)}


@pytest.mark.parametrize("where", ["load", "draw"])
def test_a_workers_exception_comes_at_its_place(where):
    loader = SceneLoader(_Failing(8, bad=5, where=where), shuffle=False,
                         num_workers=4)
    got = []
    with pytest.raises(ValueError, match=f"{where} 5"):
        for batch in loader:
            got.append(batch["index"])
    assert got == [0, 1, 2, 3, 4]


def test_four_workers_hold_at_most_five_samples():
    alive, peak = [0], [0]
    lock = threading.Lock()

    class _Token:
        pass

    def gone():
        with lock:
            alive[0] -= 1

    class Counted(_Failing):
        def load(self, i, draws):
            sample = super().load(i, draws)
            sample["token"] = token = _Token()
            weakref.finalize(token, gone)
            with lock:
                alive[0] += 1
                peak[0] = max(peak[0], alive[0])
            return sample

    loader = SceneLoader(Counted(12, bad=-1), shuffle=False, num_workers=4)
    for batch in loader:
        threading.Event().wait(0.02)        # the caller is the slow one
        del batch
    assert peak[0] == 5 and alive[0] == 0
