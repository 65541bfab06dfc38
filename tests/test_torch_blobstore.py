"""The port's blob stores (rome_tpu_torch.io.blobstore, a copy of the JAX
package's pure-Python module) on tests/test_blob_plot.py's blob fixtures,
held to the original: the same public names, the same entries for the same
payloads, and a store written by one package read by the other through a
graph checkpoint."""

import ast
import os

import numpy as np
import pytest

pytest.importorskip("torch")

import rome_tpu as R  # noqa: E402
import rome_tpu.io.blobstore as JB  # noqa: E402
import rome_tpu.io.serialization as JS  # noqa: E402

import rome_tpu_torch as T  # noqa: E402
import rome_tpu_torch.io.blobstore as TB  # noqa: E402

REPO = os.path.abspath(os.path.join(os.path.dirname(__file__), os.pardir))


def _small_graph(mod):
    fg = mod.FactorGraph()
    fg.add_variable("x0", mod.Pose2)
    fg.add_factor(["x0"], mod.PriorPose2(mod.MvNormal([0, 0, 0], [0.1, 0.1, 0.05])))
    for i in range(1, 6):
        fg.add_variable(f"x{i}", mod.Pose2)
        fg.add_factor([f"x{i-1}", f"x{i}"], mod.Pose2Pose2(mod.MvNormal([1, 0, 0.2],
                                                                       [0.1, 0.1, 0.05])))
    fg.init_all()
    return fg


@pytest.mark.parametrize("store_cls", ["FolderStore", "InMemoryStore"])
def test_blob_store_roundtrip(tmp_path, store_cls):
    fg = _small_graph(T)
    if store_cls == "FolderStore":
        store = TB.FolderStore("default_folder_store", str(tmp_path / "data"))
    else:
        store = TB.InMemoryStore()
    TB.add_blob_store(fg, store)
    payload = np.random.default_rng(0).bytes(4096)
    entry = TB.add_data(fg, "x1", "dem_tile", payload, mime="image/tiff")
    assert entry.size == 4096 and entry.mime == "image/tiff"
    assert TB.list_data_entries(fg, "x1") == ["dem_tile"]
    e2, data = TB.get_data(fg, "x1", "dem_tile")
    assert data == payload and e2.sha256 == entry.sha256
    TB.delete_data(fg, "x1", "dem_tile")
    assert TB.list_data_entries(fg, "x1") == []
    assert not store.has(entry.blob_id)


def test_blob_checksum_mismatch_raises(tmp_path):
    fg = _small_graph(T)
    store = TB.add_blob_store(fg, TB.FolderStore("s", str(tmp_path / "data")))
    entry = TB.add_data(fg, "x2", "scan", b"abc")
    store.put(entry.blob_id, b"abd")
    with pytest.raises(IOError, match="checksum"):
        TB.get_data(fg, "x2", "scan")
    with pytest.raises(KeyError):
        TB.get_blob_store(T.FactorGraph())


def test_blob_entries_survive_save_load(tmp_path):
    """Checkpoints carry blob references, not payloads: reloaded against the
    same store, the original bytes."""
    fg = _small_graph(T)
    store = TB.add_blob_store(fg, TB.FolderStore("default_folder_store", str(tmp_path / "data")))
    payload = b"\x00\x01" * 1000
    entry = TB.add_data(fg, "x2", "scan", payload)
    path = T.save_dfg(fg, str(tmp_path / "g.tar.gz"))
    assert os.path.getsize(path) < 20_000 + entry.size
    fg2 = T.load_dfg(path)
    TB.add_blob_store(fg2, store)
    e2, data = TB.get_data(fg2, "x2", "scan")
    assert data == payload and e2.blob_id == entry.blob_id


def test_same_public_names_as_the_jax_module():
    def names(path):
        tree = ast.parse(open(path).read())
        return sorted(n.name for n in tree.body
                      if isinstance(n, (ast.FunctionDef, ast.ClassDef))) + sorted(
            t.id for n in tree.body if isinstance(n, ast.Assign) for t in n.targets)

    assert names(os.path.join(REPO, "rome_tpu_torch", "io", "blobstore.py")) == names(
        os.path.join(REPO, "rome_tpu", "io", "blobstore.py"))


@pytest.mark.parametrize("origin", ["jax", "port"])
def test_a_store_crosses_the_packages(tmp_path, origin):
    """Blobs added by one package, the graph saved with its entries: the
    other package loads the graph, attaches the same folder through its own
    FolderStore and reads the same bytes; the entries are equal (but for the
    random blob id) to the ones the other package makes of the same payload."""
    mods = {"jax": (R, JB, JS.save_dfg, JS.load_dfg), "port": (T, TB, T.save_dfg, T.load_dfg)}
    other = "port" if origin == "jax" else "jax"
    mod0, B0, save0, _ = mods[origin]
    mod1, B1, _, load1 = mods[other]
    fg = _small_graph(mod0)
    folder = str(tmp_path / "blobs")
    B0.add_blob_store(fg, B0.FolderStore("ticks", folder))
    rng = np.random.default_rng(1)
    payloads = {f"x{i}": rng.normal(size=(10, 3)).tobytes() for i in range(1, 6)}
    entries = {l: B0.add_data(fg, l, "odo_ticks", p) for l, p in payloads.items()}
    fg1 = load1(save0(fg, str(tmp_path / "g.json")))
    B1.add_blob_store(fg1, B1.FolderStore("ticks", folder))
    mem = _small_graph(mod1)
    B1.add_blob_store(mem, B1.FolderStore("ticks", str(tmp_path / "other")))
    for label, payload in payloads.items():
        e, data = B1.get_data(fg1, label, "odo_ticks")
        assert data == payload and e.to_doc() == entries[label].to_doc()
        fresh = B1.add_data(mem, label, "odo_ticks", payload).to_doc()
        want = entries[label].to_doc()
        fresh.pop("blob_id"), want.pop("blob_id")
        assert fresh == want
