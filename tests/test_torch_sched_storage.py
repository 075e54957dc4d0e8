"""The scheduler's record sink (``scheduler/storage.py``) against the
reference's: the same seeded download and topology records through both
``Storage``s give byte-identical CSV files and binary block files (the
block encode joins the same ``rtt_lookup``), rotation keeps the same
files, ``snapshot_for_upload`` moves the same files aside, and the
demand observer sees every download record."""

import numpy as np
import pytest

from dragonfly2_torch.scheduler import storage as t_storage
from dragonfly2_torch.schema import synth as t_synth

from dragonfly2_tpu.scheduler import storage as j_storage
from dragonfly2_tpu.schema import synth as j_synth


def _rtt_lookup(child_ids, parent_ids):
    """A deterministic stand-in for the topology engine's affinity join."""
    child = np.asarray(child_ids).reshape(-1)
    parent = np.asarray(parent_ids).reshape(len(child), -1)
    out = np.array([[(len(c) * 7 + len(p) * 3 + ord(p[-1:] or "0")) % 50 / 10.0 for p in row]
                    for c, row in zip(child, parent)], np.float32)
    return out.reshape(np.asarray(parent_ids).shape)


def _fill(storage_mod, synth_mod, directory, downloads, topologies, **kw):
    st = storage_mod.Storage(directory, **kw)
    st.rtt_lookup = _rtt_lookup
    seen = []
    st.on_download = seen.append
    for rec in synth_mod.make_download_records(downloads, seed=11):
        st.create_download(rec)
    for rec in synth_mod.make_topology_records(topologies, num_hosts=24, seed=12):
        st.create_network_topology(rec)
    st.flush()
    return st, seen


def _files(directory):
    return {p.relative_to(directory).as_posix(): p.read_bytes() for p in sorted(directory.rglob("*")) if p.is_file()}


@pytest.mark.parametrize("downloads,topologies,kw", [
    (40, 30, {}),
    (300, 80, {"buffer_size": 16}),
    (600, 10, {"max_size": 64 << 10, "max_backups": 2}),
    (50, 50, {"write_blocks": False}),
])
def test_same_records_give_the_same_files(tmp_path, downloads, topologies, kw):
    _, seen_t = _fill(t_storage, t_synth, tmp_path / "port", downloads, topologies, **kw)
    _, seen_j = _fill(j_storage, j_synth, tmp_path / "ref", downloads, topologies, **kw)
    port, ref = _files(tmp_path / "port"), _files(tmp_path / "ref")
    assert sorted(port) == sorted(ref) and port
    for name in ref:
        assert port[name] == ref[name], name
    assert len(seen_t) == len(seen_j) == downloads


def test_snapshot_for_upload_moves_the_same_files(tmp_path):
    stores = {}
    for name, mod, syn in (("port", t_storage, t_synth), ("ref", j_storage, j_synth)):
        st, _ = _fill(mod, syn, tmp_path / name, 300, 40, buffer_size=32)
        snap = st.snapshot_for_upload()
        # records written after the snapshot land in fresh files
        for rec in syn.make_download_records(5, seed=13):
            st.create_download(rec)
        st.flush()
        stores[name] = (st, snap)
    (pst, psnap), (jst, jsnap) = stores["port"], stores["ref"]
    for field in ("download_csv", "topology_csv", "download_blocks", "topology_blocks"):
        got = [p.relative_to(tmp_path / "port") for p in getattr(psnap, field)]
        want = [p.relative_to(tmp_path / "ref") for p in getattr(jsnap, field)]
        assert got == want and want, field
        for a, b in zip(getattr(psnap, field), getattr(jsnap, field)):
            assert a.read_bytes() == b.read_bytes()
    assert (psnap.csv_superset_download, psnap.csv_superset_topology) == (
        jsnap.csv_superset_download, jsnap.csv_superset_topology)
    assert len(pst.list_download()) == len(jst.list_download()) == 5
    pst.discard_uploaded(psnap.all_files())
    jst.discard_uploaded(jsnap.all_files())
    assert _files(tmp_path / "port").keys() == _files(tmp_path / "ref").keys()


def test_blocks_off_era_ships_csv(tmp_path):
    # a sink restarted with blocks on over CSV-only history flags the era
    for name, mod, syn in (("port", t_storage, t_synth), ("ref", j_storage, j_synth)):
        _fill(mod, syn, tmp_path / name, 20, 5, write_blocks=False)
    snaps = [mod.Storage(tmp_path / name).snapshot_for_upload()
             for name, mod in (("port", t_storage), ("ref", j_storage))]
    assert [(s.csv_superset_download, s.csv_superset_topology) for s in snaps] == [(True, True)] * 2
