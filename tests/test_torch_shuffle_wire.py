"""The network shuffle's wire format, held byte for byte against the JAX
package: the copied modules are the reference's text, ``TableMeta`` and
the host pack give the same bytes for every dtype, each package reads the
other's buffers, the device pack gives the host pack's bytes on the CPU,
and the codecs, checksums and control messages are the reference's."""
import datetime
from pathlib import Path

import numpy as np
import pyarrow as pa
import pytest
import torch

import spark_rapids_tpu.shuffle.codec as jcodec
import spark_rapids_tpu.shuffle.messages as jmsg
import spark_rapids_tpu.shuffle.table_meta as jtm
import spark_rapids_tpu_torch.shuffle.codec as pcodec
import spark_rapids_tpu_torch.shuffle.messages as pmsg
import spark_rapids_tpu_torch.shuffle.table_meta as ptm
from spark_rapids_tpu.columnar.batch import DeviceBatch as JaxDeviceBatch
from spark_rapids_tpu.columnar.host import HostBatch as JaxHostBatch
from spark_rapids_tpu.shuffle.catalog import ShuffleBlockId as JaxBlock
from spark_rapids_tpu.testing import assert_tables_equal
from spark_rapids_tpu_torch.columnar.host import HostBatch
from spark_rapids_tpu_torch.columnar.transfer import download, upload
from spark_rapids_tpu_torch.parallel.broadcast import (capacity_host_batch,
                                                       deserialize_batch,
                                                       serialize_batch)
from spark_rapids_tpu_torch.shuffle.catalog import ShuffleBlockId
from tests.torch_cluster_common import CPU, one_torch_thread  # noqa: F401

ROOT = Path(__file__).resolve().parents[1]

#: the modules the port keeps as the reference's text (module table rows
#: 2-9): byte-equal after the one package-name substitution
COPIES = ("lz4", "codec", "retry", "messages", "transport", "inprocess",
          "tcp", "faults")


@pytest.mark.parametrize("name", COPIES)
def test_copies_are_the_reference_text(name):
    ref = (ROOT / "spark_rapids_tpu" / "shuffle" / f"{name}.py").read_text()
    port = (ROOT / "spark_rapids_tpu_torch" / "shuffle"
            / f"{name}.py").read_text()
    assert port == ref.replace("spark_rapids_tpu", "spark_rapids_tpu_torch")


def wide_table(n: int, seed: int) -> pa.Table:
    """Every dtype, about a fifth null; floats with NaN, +-0.0, +-inf and a
    huge value; strings of mixed widths (multibyte too), two string columns
    of different widths; dates before 1970."""
    rng = np.random.default_rng(seed)

    def arr(vals, typ):
        m = rng.random(n) < 0.2
        return pa.array([None if mm else v for v, mm in zip(vals, m)], typ)

    f = rng.normal(size=n)
    f[:6] = [np.nan, 0.0, -0.0, np.inf, -np.inf, 1e300][:n]
    with np.errstate(over="ignore"):
        f32 = f.astype(np.float32)
    return pa.table({
        "b": arr([bool(x) for x in rng.integers(0, 2, n)], pa.bool_()),
        "i8": arr(rng.integers(-128, 127, n).tolist(), pa.int8()),
        "i16": arr(rng.integers(-3000, 3000, n).tolist(), pa.int16()),
        "i32": arr(rng.integers(-2**31, 2**31 - 1, n).tolist(), pa.int32()),
        "i64": arr(rng.integers(-2**62, 2**62, n).tolist(), pa.int64()),
        "f32": arr(f32.tolist(), pa.float32()),
        "f64": arr(f.tolist(), pa.float64()),
        "s": arr(["x" * int(k) + "é" * int(k % 3)
                  for k in rng.integers(0, 40, n)], pa.string()),
        "s2": arr([f"k{k}" for k in rng.integers(0, 9, n)], pa.string()),
        "d": arr([datetime.date(1960, 1, 1) + datetime.timedelta(days=int(k))
                  for k in rng.integers(0, 30000, n)], pa.date32()),
        "ts": arr([int(k) for k in rng.integers(0, 2**40, n)],
                  pa.timestamp("us", tz="UTC")),
    })


TABLES = {"rows37": (37, 1), "rows300": (300, 3), "rows1": (1, 5),
          "empty": (0, 2)}


@pytest.fixture(params=sorted(TABLES))
def table(request):
    return wide_table(*TABLES[request.param])


def test_host_pack_and_meta_equal_the_reference(table):
    jraw, jmeta = jtm.pack_host_batch(JaxHostBatch.from_arrow(table))
    praw, pmeta = ptm.pack_host_batch(HostBatch.from_arrow(table))
    assert praw == jraw
    assert pmeta.to_bytes() == jmeta.to_bytes()
    assert pmeta.checksum == jmeta.checksum
    assert pmeta.checksum != 0 or not praw      # crc32(b"") is 0
    back = ptm.TableMeta.from_bytes(pmeta.to_bytes())
    assert back == pmeta and back.schema == pmeta.schema


def test_each_package_reads_the_others_bytes(table):
    jraw, jmeta = jtm.pack_host_batch(JaxHostBatch.from_arrow(table))
    praw, pmeta = ptm.pack_host_batch(HostBatch.from_arrow(table))
    by_port = ptm.unpack_host_batch(jraw, ptm.TableMeta.from_bytes(
        jmeta.to_bytes()))
    by_jax = jtm.unpack_host_batch(praw, jtm.TableMeta.from_bytes(
        pmeta.to_bytes()))
    want = HostBatch.from_arrow(table).to_arrow()
    assert_tables_equal(want, by_port.to_arrow())
    assert_tables_equal(JaxHostBatch.from_arrow(table).to_arrow(),
                        by_jax.to_arrow())
    assert_tables_equal(want, by_jax.to_arrow())


def _port_device(table):
    return upload(HostBatch.from_arrow(table), CPU)


def test_device_pack_is_the_host_pack_and_the_reference(table):
    """The device pack of a capacity-sized batch (DOUBLE included) gives
    the host pack's bytes, padding zeros too, and the JAX package's
    device pack of the same input."""
    db = ptm.uniform_string_batch(_port_device(table))
    layout = ptm.DevicePackLayout.for_batch_shape(
        db.schema, db.capacity, ptm.batch_string_max(db))
    packed = ptm.device_pack(db, layout)
    assert packed.dtype == torch.uint8 and packed.device == CPU
    raw, meta = ptm.pack_host_batch(capacity_host_batch(db))
    assert packed.numpy().tobytes() == raw
    assert meta.packed_size == layout.total_size
    assert ptm.layout_to_meta(layout, db.num_rows).columns == meta.columns
    jdb = jtm.uniform_string_batch(JaxDeviceBatch.from_arrow(table))
    jlayout = jtm.DevicePackLayout.for_batch_shape(
        jdb.schema, jdb.capacity, jtm.batch_string_max(jdb))
    assert np.asarray(jtm.device_pack(jdb, jlayout)).tobytes() == raw


def test_device_unpack_and_upload_round_trip(table):
    db = ptm.uniform_string_batch(_port_device(table))
    layout = ptm.DevicePackLayout.for_batch_shape(
        db.schema, db.capacity, ptm.batch_string_max(db))
    packed = ptm.device_pack(db, layout)
    back = ptm.device_unpack(packed, layout, db.num_rows)
    want = download(db).to_arrow()
    assert_tables_equal(want, download(back).to_arrow())
    for a, b in zip(back.columns, db.columns):
        assert torch.equal(a.validity, b.validity)
    # the reader's path: the host bytes copied up whole, then viewed
    raw, meta = ptm.pack_host_batch(capacity_host_batch(db))
    up = ptm.upload_packed(raw, meta, CPU)
    assert up.capacity == db.capacity
    assert_tables_equal(want, download(up).to_arrow())
    # the host unpack, then the upload of its capacity-sized arrays
    hb = ptm.unpack_host_batch(raw, meta)
    assert_tables_equal(want, download(ptm.host_to_device_batch(
        hb, CPU)).to_arrow())
    # a broadcast's bytes: the capacity-sized host batch behind its meta
    blob = serialize_batch(capacity_host_batch(db))
    assert_tables_equal(want, download(upload(deserialize_batch(blob),
                                              CPU)).to_arrow())


def test_unpack_refuses_corrupt_and_compressed_buffers():
    raw, meta = ptm.pack_host_batch(HostBatch.from_arrow(wide_table(50, 6)))
    bad = bytearray(raw)
    bad[len(bad) // 2] ^= 0xFF
    for unpack in (ptm.unpack_host_batch,
                   lambda b, m: ptm.upload_packed(b, m, CPU)):
        with pytest.raises(ptm.ChecksumError, match="checksum mismatch"):
            unpack(bytes(bad), meta)
        with pytest.raises(ValueError, match="still compressed"):
            unpack(raw, meta.with_codec("zlib", len(raw)))
    # the JAX package refuses the same corrupt bytes
    with pytest.raises(jtm.ChecksumError):
        jtm.unpack_host_batch(bytes(bad), jtm.TableMeta.from_bytes(
            meta.to_bytes()))
    with pytest.raises(ValueError, match="unsupported TableMeta version"):
        ptm.TableMeta.from_bytes(meta.to_bytes()[:4] + b"\x09\x00"
                                 + meta.to_bytes()[6:])


CODECS = ("copy", "none", "zlib", "lz4", "zstd")


@pytest.mark.parametrize("name", CODECS)
def test_codec_output_and_checksums_equal_the_reference(name):
    if name == "zstd":
        pytest.importorskip("zstandard")
    raw, meta = ptm.pack_host_batch(HostBatch.from_arrow(wide_table(400, 7)))
    pwire, pmeta = pcodec.compress_batch(raw, meta, pcodec.get_codec(name))
    jwire, jmeta = jcodec.compress_batch(
        raw, jtm.TableMeta.from_bytes(meta.to_bytes()),
        jcodec.get_codec(name))
    assert pwire == jwire
    assert pmeta.to_bytes() == jmeta.to_bytes()
    assert pcodec.checksum_of(pwire) == jcodec.checksum_of(jwire)
    # each package decompresses the other's wire bytes
    back, bmeta = pcodec.decompress_batch(jwire, pmeta)
    assert back == raw and bmeta.codec == "copy"
    jback, _ = jcodec.decompress_batch(pwire, jmeta)
    assert jback == raw


def test_unknown_codecs_are_refused_as_in_the_reference():
    for codec in (pcodec, jcodec):
        with pytest.raises(ValueError, match="unknown shuffle codec"):
            codec.get_codec("lz77")
    assert pcodec.available_codecs() == jcodec.available_codecs()
    crc = pcodec.checksum_of(b"abc")
    pcodec.verify_checksum(b"abc", crc)
    pcodec.verify_checksum(b"abd", 0)           # 0 = not computed
    with pytest.raises(pcodec.ChecksumError, match="checksum mismatch"):
        pcodec.verify_checksum(b"abd", crc)


def test_control_messages_equal_the_reference():
    meta = ptm.pack_host_batch(HostBatch.from_arrow(wide_table(20, 8)))[1]
    jmeta = jtm.TableMeta.from_bytes(meta.to_bytes())
    blocks = (ShuffleBlockId(3, 1, 0), ShuffleBlockId(3, 4, 0))
    jblocks = tuple(JaxBlock(*(b.shuffle_id, b.map_id, b.partition_id))
                    for b in blocks)
    pairs = [
        (pmsg.MetadataRequest(3, 0, blocks),
         jmsg.MetadataRequest(3, 0, jblocks)),
        (pmsg.MetadataResponse(((blocks[0], 0, meta), (blocks[1], 2, meta))),
         jmsg.MetadataResponse(((jblocks[0], 0, jmeta),
                                (jblocks[1], 2, jmeta)))),
        (pmsg.TransferRequest(blocks[1], 2, 7 << 16, 4096, "lz4"),
         jmsg.TransferRequest(jblocks[1], 2, 7 << 16, 4096, "lz4")),
        (pmsg.TransferResponse(1234, meta.with_checksum(99), 99),
         jmsg.TransferResponse(1234, jmeta.with_checksum(99), 99)),
    ]
    for p, j in pairs:
        assert p.to_bytes() == j.to_bytes()
        assert type(p).from_bytes(j.to_bytes()) == p


def test_error_payloads_cross_the_process_boundary():
    """The scoped fetch error keeps its executor and blocks through the
    daemon's wire codec; an unregistered type ships opaque."""
    import pickle

    from spark_rapids_tpu_torch.shuffle.manager import \
        ShuffleFetchFailedError
    from spark_rapids_tpu_torch.utils import errors as uerr
    blocks = (ShuffleBlockId(3, 1, 0), ShuffleBlockId(3, 4, 0))
    err = ShuffleFetchFailedError("lost blocks on exec-9",
                                  executor_id="exec-9", blocks=blocks)
    back = pickle.loads(pickle.dumps(err))
    assert back.executor_id == "exec-9" and tuple(back.blocks) == blocks
    wire = uerr.encode_error(err)
    assert wire["code"] == "SHUFFLE_FETCH_FAILED"
    rebuilt = uerr.decode_error(wire)
    assert isinstance(rebuilt, ShuffleFetchFailedError)
    assert rebuilt.executor_id == "exec-9" and rebuilt.blocks == blocks
    assert rebuilt.blocks[0].map_id == 1
    opaque = uerr.decode_error(uerr.encode_error(KeyError("x")))
    assert isinstance(opaque, uerr.OpaqueWireError)
    assert uerr.classification_for(ptm.ChecksumError()) == uerr.RETRYABLE
    from spark_rapids_tpu.utils import errors as jerr
    assert [(s.name, s.classification, s.wire_code, s.fields)
            for s in uerr.TAXONOMY] == [
        (s.name, s.classification, s.wire_code, s.fields)
        for s in jerr.TAXONOMY]
