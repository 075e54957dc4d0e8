"""The port's record and wire layers (dragonfly2_torch.schema: records,
columnar, features, synth, wire; utils.idgen) against the JAX package's on
the CPU. Blocks encoded by either package decode in the other bit for bit
— pairs, columns, ``download_index`` rebasing, record counts, spans — and
the same seeded records encode to the same bytes; a corrupted checksum
raises in both."""

import numpy as np
import pytest
import torch

from dragonfly2_torch.schema import columnar as t_columnar
from dragonfly2_torch.schema import features as t_features
from dragonfly2_torch.schema import records as t_records
from dragonfly2_torch.schema import synth as t_synth
from dragonfly2_torch.schema import wire as t_wire
from dragonfly2_torch.utils import idgen as t_idgen
from dragonfly2_tpu.schema import columnar as j_columnar
from dragonfly2_tpu.schema import features as j_features
from dragonfly2_tpu.schema import records as j_records
from dragonfly2_tpu.schema import synth as j_synth
from dragonfly2_tpu.schema import wire as j_wire
from dragonfly2_tpu.utils import idgen as j_idgen

torch.set_num_threads(1)

PACKAGES = {"port": (t_wire, t_synth), "reference": (j_wire, j_synth)}
DIRECTIONS = [("port", "reference"), ("reference", "port")]
DIRECTION_IDS = ["port-encodes", "reference-encodes"]


def _cols_equal(a: dict, b: dict) -> None:
    assert list(a) == list(b)
    for k in a:
        assert a[k].dtype == b[k].dtype, k
        assert a[k].shape == b[k].shape, k
        assert np.array_equal(a[k], b[k]), k


def _train_file(tmp_path, who, n=300, per_block=64, seed=1):
    wire, synth = PACKAGES[who]
    recs = synth.make_download_records(n, seed=seed)
    data = b"".join(
        wire.encode_train_block(recs[i : i + per_block]) for i in range(0, n, per_block)
    )
    path = tmp_path / f"{who}.dfb"
    path.write_bytes(data)
    return path, data


def _topology_file(tmp_path, who, n=120, seed=2):
    wire, synth = PACKAGES[who]
    recs = synth.make_topology_records(n, num_hosts=24, seed=seed)
    data = b"".join(wire.encode_topology_block(recs[i : i + 50]) for i in range(0, n, 50))
    path = tmp_path / f"{who}-topo.dfb"
    path.write_bytes(data)
    return path, data


@pytest.mark.parametrize("n,seed", [(1, 0), (50, 3), (130, 7)])
def test_same_records_encode_to_the_same_bytes(n, seed):
    t_recs = t_synth.make_download_records(n, seed=seed)
    j_recs = j_synth.make_download_records(n, seed=seed)
    assert [t_records.flatten(r) for r in t_recs] == [j_records.flatten(r) for r in j_recs]
    assert t_wire.encode_train_block(t_recs) == j_wire.encode_train_block(j_recs)
    t_topo = t_synth.make_topology_records(n, num_hosts=16, seed=seed)
    j_topo = j_synth.make_topology_records(n, num_hosts=16, seed=seed)
    assert t_wire.encode_topology_block(t_topo) == j_wire.encode_topology_block(j_topo)


@pytest.mark.parametrize("src,dst", DIRECTIONS, ids=DIRECTION_IDS)
def test_train_pairs_decode_bit_for_bit(tmp_path, src, dst):
    path, _ = _train_file(tmp_path, src)
    got = PACKAGES[dst][0].read_train_pairs(path)
    want = PACKAGES[src][0].read_train_pairs(path)
    for f in ("features", "labels", "download_index"):
        a, b = getattr(got, f), getattr(want, f)
        assert a.dtype == b.dtype and np.array_equal(a, b), f
    assert got.num_downloads == want.num_downloads == 300
    # download_index is rebased onto the running record count
    assert got.download_index.max() > 64 and np.all(np.diff(got.download_index) >= 0)
    # an offset/end window decodes alike too
    spans = t_wire.scan_block_extents(path)
    a = PACKAGES[dst][0].read_train_pairs(path, offset=spans[1][0], end=spans[3][1])
    b = PACKAGES[src][0].read_train_pairs(path, offset=spans[1][0], end=spans[3][1])
    assert np.array_equal(a.features, b.features) and a.num_downloads == b.num_downloads == 192


@pytest.mark.parametrize("src,dst", DIRECTIONS, ids=DIRECTION_IDS)
def test_topology_columns_decode_bit_for_bit(tmp_path, src, dst):
    path, _ = _topology_file(tmp_path, src)
    kind = t_wire.KIND_TOPOLOGY
    _cols_equal(
        PACKAGES[dst][0].read_columns(path, kind=kind),
        PACKAGES[src][0].read_columns(path, kind=kind),
    )
    # and the columns are the records' own
    _cols_equal(
        t_columnar.records_to_columns(t_synth.make_topology_records(120, num_hosts=24, seed=2)),
        j_columnar.records_to_columns(j_synth.make_topology_records(120, num_hosts=24, seed=2)),
    )


@pytest.mark.parametrize("src,dst", DIRECTIONS, ids=DIRECTION_IDS)
def test_counts_spans_and_extents_agree(tmp_path, src, dst):
    path, data = _train_file(tmp_path, src, n=600, per_block=32)
    a, b = PACKAGES[dst][0], PACKAGES[src][0]
    assert a.is_block_file(path) and b.is_block_file(path)
    assert a.count_records(path) == b.count_records(path) == 600
    assert a.count_records(path, max_records=100) == b.count_records(path, max_records=100)
    assert a.scan_block_extents(path) == b.scan_block_extents(path)
    assert [tuple(vars(s).values()) for s in a.scan_blocks(path)] == [
        tuple(vars(s).values()) for s in b.scan_blocks(path)
    ]
    for target in (1, 5000, 1 << 20):
        assert a.split_block_spans([path], target_span_bytes=target) == b.split_block_spans(
            [path], target_span_bytes=target
        )
    # a torn tail: the complete prefix decodes alike
    torn = path.with_name("torn.dfb")
    torn.write_bytes(data[: len(data) - 100])
    assert a.count_records(torn) == b.count_records(torn) == 576  # 18 whole blocks of 32
    assert np.array_equal(a.read_train_pairs(torn).labels, b.read_train_pairs(torn).labels)


@pytest.mark.parametrize("half", [False, True])
def test_stream_train_pairs_agree(tmp_path, half):
    path, _ = _train_file(tmp_path, "reference", n=400, per_block=50)
    spans = t_wire.split_block_spans([path], target_span_bytes=20_000)
    got = list(t_wire.stream_train_pairs(spans, passes=2, half=half))
    want = list(j_wire.stream_train_pairs(spans, passes=2, half=half))
    assert len(got) == len(want) == 16
    for (f, l, r), (g, m, s) in zip(got, want):
        assert f.dtype == g.dtype and np.array_equal(f, g) and np.array_equal(l, m) and r == s
    got = list(t_wire.stream_train_pairs(path, max_records=120, half=half))
    want = list(j_wire.stream_train_pairs(path, max_records=120, half=half))
    assert [r for *_, r in got] == [r for *_, r in want] == [50, 100, 150]


@pytest.mark.parametrize("who", ["port", "reference"])
def test_a_corrupted_checksum_raises_in_both(tmp_path, who):
    path, data = _train_file(tmp_path, who, n=64, per_block=64)
    bad = bytearray(data)
    bad[-3] ^= 0xFF  # a payload byte of the only block
    path.write_bytes(bytes(bad))
    for wire in (t_wire, j_wire):
        with pytest.raises(wire.WireError, match="crc"):
            wire.read_train_pairs(path)
        # decoding without the check still works, alike
    a = t_wire.read_train_pairs(path, verify_crc=False)
    b = j_wire.read_train_pairs(path, verify_crc=False)
    assert np.array_equal(a.labels, b.labels, equal_nan=True)


def test_generic_blocks_cross_decode():
    cols = {
        "i": np.arange(10, dtype=np.int64),
        "z": np.zeros(10, np.float32),
        "s": np.array(["idc-a", "idc-b"] * 5),
        "nl": np.array([f"a\nb{i}" for i in range(10)]),  # newline: raw, never dict
        "f": np.linspace(0, 1, 20, dtype=np.float64).reshape(10, 2),
    }
    for enc, dec in ((t_wire, j_wire), (j_wire, t_wire)):
        block = enc.encode_block(cols, "x", records=7, meta={"k": 1})
        assert block == dec.encode_block(cols, "x", records=7, meta={"k": 1})
        header, got, end = dec.decode_block(block)
        assert end == len(block) and header["records"] == 7 and header["meta"] == {"k": 1}
        _cols_equal(got, cols)


def test_columnar_and_csv_round_trip(tmp_path):
    recs = j_synth.make_download_records(20, seed=4)
    path = tmp_path / "d.csv"
    j_columnar.write_csv(path, recs)
    got = t_columnar.read_csv(path, t_records.DownloadRecord)
    want = j_columnar.read_csv(path, j_records.DownloadRecord)
    assert [t_records.flatten(r) for r in got] == [j_records.flatten(r) for r in want]
    assert t_records.headers(t_records.DownloadRecord) == j_records.headers(j_records.DownloadRecord)
    a = t_columnar.records_to_columns(got)
    _cols_equal(a, j_columnar.records_to_columns(want))
    assert t_columnar.num_rows(a) == 20 and t_columnar.num_rows({}) == 0
    _cols_equal(
        t_columnar.concat_columns([a, {}, a]), j_columnar.concat_columns([a, {}, a])
    )


@pytest.mark.parametrize("n,parents", [(0, 4), (40, 4), (25, 1)])
def test_pair_features_and_sequences_agree(n, parents):
    recs = j_synth.make_download_records(n, seed=5, parents_per_record=parents)
    cols = j_columnar.records_to_columns(recs)
    got, want = t_features.extract_pair_features(cols), j_features.extract_pair_features(cols)
    for f in ("features", "labels", "download_index"):
        assert np.array_equal(getattr(got, f), getattr(want, f)), f
    assert got.num_downloads == want.num_downloads == n
    got, want = t_features.extract_piece_sequences(cols), j_features.extract_piece_sequences(cols)
    for f in ("sequences", "labels", "lengths"):
        assert np.array_equal(getattr(got, f), getattr(want, f)), f


def test_pair_tensors_agree():
    for a, b in zip(t_synth.make_pair_tensors(500, seed=3), j_synth.make_pair_tensors(500, seed=3)):
        assert np.array_equal(a, b)


def test_synthesized_dataset_is_the_reference_bytes(tmp_path, monkeypatch):
    # the group shrunk from 2,000 records to 150 in both packages, for time
    for synth in (t_synth, j_synth):
        make = synth.make_download_records
        monkeypatch.setattr(synth, "make_download_records", lambda n, seed=0, m=make: m(150, seed))
    (tmp_path / "t").mkdir()
    (tmp_path / "j").mkdir()
    got = t_synth.synthesize_dataset_binary(str(tmp_path / "t"), 2, 200_000, records_per_block=64)
    want = j_synth.synthesize_dataset_binary(str(tmp_path / "j"), 2, 200_000, records_per_block=64)
    assert [open(p, "rb").read() for p in got] == [open(p, "rb").read() for p in want]
    assert t_wire.count_records(got[0]) == 150 * (200_000 // t_wire.scan_block_extents(got[0])[2][1])


@pytest.mark.parametrize(
    "ip,hostname", [("10.0.0.1", "sched-a"), ("", ""), ("fe80::1", "hôte-ü")]
)
def test_ids_are_the_references(ip, hostname):
    assert t_idgen.host_id_v2(ip, hostname) == j_idgen.host_id_v2(ip, hostname)
    assert t_idgen.mlp_model_id_v1(ip, hostname) == j_idgen.mlp_model_id_v1(ip, hostname)
    assert t_idgen.gnn_model_id_v1(ip, hostname) == j_idgen.gnn_model_id_v1(ip, hostname)
