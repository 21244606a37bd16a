"""Pure-Python rosbag (v2.0) PointCloud2 reader — the replay input path.

The reference is driven by ``rosbag play xxx.bag`` feeding
``sensor_msgs/PointCloud2`` scans to the nodes (README.md:27-41).  This
module replaces that with a dependency-free bag parser so real recorded
logs run through ``alego_tpu_torch.cli --bag file.bag`` with no ROS install
(a copy of the reference package's reader and writer):

* bag format 2.0 (the format every ROS1 ``rosbag record`` writes)
* sequential chunk scan — no index required (also reads unindexed /
  crashed bags, like ``rosbag reindex`` targets)
* ``none`` and ``bz2`` chunk compression (stdlib); ``lz4`` raises with a
  clear message
* PointCloud2 decoding via a NumPy strided view: x/y/z (+ any extra
  fields) are pulled straight out of the record buffer, no per-point loop

A minimal writer (uncompressed, single chunk) is included for round-trip
tests and for converting frame directories into shareable bags.

Format notes (parsed from the public rosbag spec): records are
``<u32 hlen><header><u32 dlen><data>``; headers are ``<u32 flen>name=value``
fields; op codes: 0x02 message data, 0x03 bag header, 0x05 chunk,
0x07 connection.
"""

from __future__ import annotations

import bz2
import os
import struct
from typing import Iterator, Optional, Tuple

import numpy as np

MAGIC = b"#ROSBAG V2.0\n"

OP_MSG = 0x02
OP_BAG_HEADER = 0x03
OP_INDEX = 0x04
OP_CHUNK = 0x05
OP_CHUNK_INFO = 0x06
OP_CONNECTION = 0x07

PC2_TYPE = "sensor_msgs/PointCloud2"
IMU_TYPE = "sensor_msgs/Imu"

# PointField datatype enum -> numpy dtype (sensor_msgs/PointField.msg)
_PF_DTYPE = {1: np.int8, 2: np.uint8, 3: np.int16, 4: np.uint16,
             5: np.int32, 6: np.uint32, 7: np.float32, 8: np.float64}


def _parse_header(buf: bytes) -> dict:
    fields, off = {}, 0
    while off < len(buf):
        (flen,) = struct.unpack_from("<I", buf, off)
        off += 4
        eq = buf.index(b"=", off, off + flen)
        fields[buf[off:eq].decode()] = buf[eq + 1: off + flen]
        off += flen
    return fields


def _iter_records(buf: bytes) -> Iterator[Tuple[dict, bytes]]:
    off = 0
    n = len(buf)
    while off + 4 <= n:
        (hlen,) = struct.unpack_from("<I", buf, off)
        off += 4
        header = _parse_header(buf[off: off + hlen])
        off += hlen
        (dlen,) = struct.unpack_from("<I", buf, off)
        off += 4
        yield header, buf[off: off + dlen]
        off += dlen


def _u32(b: bytes) -> int:
    return struct.unpack("<I", b)[0]


class PointCloud2:
    """Decoded sensor_msgs/PointCloud2: ``.stamp`` (float seconds),
    ``.frame_id``, ``.fields`` {name: (offset, dtype, count)}, and
    ``.array(names)`` -> [N, len(names)] float32."""

    def __init__(self, raw: bytes):
        off = 0
        # std_msgs/Header: seq, stamp(secs,nsecs), frame_id
        _, secs, nsecs = struct.unpack_from("<III", raw, off)
        off += 12
        (slen,) = struct.unpack_from("<I", raw, off)
        off += 4
        self.frame_id = raw[off: off + slen].decode(errors="replace")
        off += slen
        self.stamp = secs + nsecs * 1e-9
        self.height, self.width = struct.unpack_from("<II", raw, off)
        off += 8
        (nfields,) = struct.unpack_from("<I", raw, off)
        off += 4
        self.fields = {}
        for _ in range(nfields):
            (nlen,) = struct.unpack_from("<I", raw, off)
            off += 4
            name = raw[off: off + nlen].decode()
            off += nlen
            foff, dtype, count = struct.unpack_from("<IBI", raw, off)
            off += 9
            self.fields[name] = (foff, _PF_DTYPE.get(dtype, np.uint8), count)
        self.is_bigendian = raw[off]
        off += 1
        self.point_step, self.row_step = struct.unpack_from("<II", raw, off)
        off += 8
        (dlen,) = struct.unpack_from("<I", raw, off)
        off += 4
        self._data = raw[off: off + dlen]
        off += dlen
        self.is_dense = bool(raw[off]) if off < len(raw) else True

    @property
    def n_points(self) -> int:
        return self.height * self.width

    def array(self, names=("x", "y", "z")) -> np.ndarray:
        """Extract named fields as [N, len(names)] float32 (strided view)."""
        n = self.n_points
        buf = np.frombuffer(self._data, np.uint8)[: n * self.point_step]
        buf = buf.reshape(n, self.point_step)
        cols = []
        for name in names:
            foff, dt, _ = self.fields[name]
            w = np.dtype(dt).itemsize
            col = buf[:, foff: foff + w].copy().view(dt)[:, 0]
            if self.is_bigendian:
                col = col.byteswap()
            cols.append(col.astype(np.float32))
        return np.stack(cols, axis=-1)


class ImuMsg:
    """Parsed sensor_msgs/Imu (the reference's /imu/data input,
    utility.h:68, LO.cpp:840-881)."""

    __slots__ = ("stamp", "frame_id", "quat", "ang_vel", "lin_acc")

    def __init__(self, raw: bytes):
        off = 4                                     # header.seq
        secs, nsecs = struct.unpack_from("<II", raw, off)
        off += 8
        (flen,) = struct.unpack_from("<I", raw, off)
        off += 4
        self.frame_id = raw[off: off + flen].decode()
        off += flen
        self.stamp = secs + nsecs * 1e-9
        self.quat = np.frombuffer(raw, "<f8", 4, off)        # x y z w
        off += 32 + 72                               # quat + orientation cov
        self.ang_vel = np.frombuffer(raw, "<f8", 3, off)
        off += 24 + 72
        self.lin_acc = np.frombuffer(raw, "<f8", 3, off)

    def rpy(self) -> np.ndarray:
        """Roll/pitch/yaw (ZYX convention, matching tf::getRPY as the
        reference uses in its imuHandler, LO.cpp:843-845)."""
        x, y, z, w = self.quat
        roll = np.arctan2(2 * (w * x + y * z), 1 - 2 * (x * x + y * y))
        pitch = np.arcsin(np.clip(2 * (w * y - z * x), -1, 1))
        yaw = np.arctan2(2 * (w * z + x * y), 1 - 2 * (y * y + z * z))
        return np.array([roll, pitch, yaw])


def _decompress(compression: str, data: bytes, size: int) -> bytes:
    if compression == "none":
        return data
    if compression == "bz2":
        return bz2.decompress(data)
    raise NotImplementedError(
        f"bag chunk compression {compression!r} not supported "
        "(re-record with --bz2 or none, or `rosbag decompress` first)")


def read_bag_messages(path: str, topic: Optional[str] = None,
                      types: Tuple[str, ...] = (PC2_TYPE, IMU_TYPE),
                      imu_topic: Optional[str] = "/imu/data",
                      ) -> Iterator[Tuple[float, str, str, object]]:
    """Yield (record_time_s, topic, type, msg) for every message of a
    supported type (PointCloud2 / Imu) in file order; ``topic`` filters
    PointCloud2 topics, ``imu_topic`` filters Imu topics (default
    ``/imu/data`` — the reference's subscription, LO.cpp:116; a bag with
    several IMU streams, e.g. /imu/raw + /imu/data, must not interleave
    conflicting orientations into the de-skew buffer).  Pass
    ``imu_topic=None`` to accept any single IMU stream.  Streams
    chunk-by-chunk."""
    conns = {}          # conn id -> (topic, type)

    def handle(records):
        for h, data in records:
            op = h["op"][0]
            if op == OP_CONNECTION:
                info = _parse_header(data)
                conns[_u32(h["conn"])] = (
                    h.get("topic", info.get("topic", b"")).decode(),
                    info.get("type", b"").decode())
            elif op == OP_MSG:
                cid = _u32(h["conn"])
                ctopic, ctype = conns.get(cid, ("", ""))
                if ctype not in types:
                    continue
                if ctype == PC2_TYPE and topic and ctopic != topic:
                    continue
                if ctype == IMU_TYPE and imu_topic and ctopic != imu_topic:
                    continue
                secs, nsecs = struct.unpack("<II", h["time"])
                msg = (PointCloud2(data) if ctype == PC2_TYPE
                       else ImuMsg(data))
                yield secs + nsecs * 1e-9, ctopic, ctype, msg

    with open(path, "rb") as f:
        if f.read(len(MAGIC)) != MAGIC:
            raise ValueError(f"{path}: not a ROS bag v2.0 file")
        while True:
            head = f.read(4)
            if len(head) < 4:
                return
            (hlen,) = struct.unpack("<I", head)
            header = _parse_header(f.read(hlen))
            (dlen,) = struct.unpack("<I", f.read(4))
            op = header["op"][0]
            if op == OP_CHUNK:
                blob = _decompress(header["compression"].decode(),
                                   f.read(dlen), _u32(header["size"]))
                yield from handle(_iter_records(blob))
            elif op in (OP_CONNECTION, OP_MSG):
                # unchunked records (unindexed/minimal writers)
                yield from handle([(header, f.read(dlen))])
            else:
                f.seek(dlen, os.SEEK_CUR)


def read_bag_pointclouds(path: str, topic: Optional[str] = None,
                         ) -> Iterator[Tuple[float, str, PointCloud2]]:
    """Yield (record_time_s, topic, PointCloud2) — PC2-only view."""
    for t, tp, ty, msg in read_bag_messages(path, topic, types=(PC2_TYPE,)):
        yield t, tp, msg


def bag_topics(path: str) -> dict:
    """{topic: (type, message_count)} — a `rosbag info` lite."""
    out = {}
    conns = {}
    with open(path, "rb") as f:
        if f.read(len(MAGIC)) != MAGIC:
            raise ValueError(f"{path}: not a ROS bag v2.0 file")
        while True:
            head = f.read(4)
            if len(head) < 4:
                break
            (hlen,) = struct.unpack("<I", head)
            header = _parse_header(f.read(hlen))
            (dlen,) = struct.unpack("<I", f.read(4))
            op = header["op"][0]
            if op == OP_CHUNK:
                blob = _decompress(header["compression"].decode(),
                                   f.read(dlen), _u32(header["size"]))
                for h, data in _iter_records(blob):
                    o = h["op"][0]
                    if o == OP_CONNECTION:
                        info = _parse_header(data)
                        conns[_u32(h["conn"])] = (
                            h.get("topic", info.get("topic", b"")).decode(),
                            info.get("type", b"").decode())
                    elif o == OP_MSG:
                        t, ty = conns.get(_u32(h["conn"]), ("?", "?"))
                        k = out.setdefault(t, [ty, 0])
                        k[1] += 1
            elif op == OP_CONNECTION:
                info = _parse_header(f.read(dlen))
                conns[_u32(header["conn"])] = (
                    header.get("topic", info.get("topic", b"")).decode(),
                    info.get("type", b"").decode())
            elif op == OP_MSG:
                t, ty = conns.get(_u32(header["conn"]), ("?", "?"))
                k = out.setdefault(t, [ty, 0])
                k[1] += 1
            else:
                f.seek(dlen, os.SEEK_CUR)
    return {t: tuple(v) for t, v in out.items()}


# ---------------------------------------------------------------------------
# Minimal writer — round-trip tests + frames->bag conversion
# ---------------------------------------------------------------------------

def _header(fields: dict) -> bytes:
    out = b""
    for k, v in fields.items():
        kv = k.encode() + b"=" + v
        out += struct.pack("<I", len(kv)) + kv
    return out


def _record(fields: dict, data: bytes) -> bytes:
    h = _header(fields)
    return struct.pack("<I", len(h)) + h + struct.pack("<I", len(data)) + data


def _serialize_pc2(stamp: float, frame_id: str, xyz: np.ndarray,
                   intensity: Optional[np.ndarray] = None) -> bytes:
    xyz = np.ascontiguousarray(xyz, np.float32)
    n = xyz.shape[0]
    fields = [(b"x", 0, 7, 1), (b"y", 4, 7, 1), (b"z", 8, 7, 1)]
    step = 12
    if intensity is not None:
        fields.append((b"intensity", 12, 7, 1))
        step = 16
        body = np.concatenate(
            [xyz, np.asarray(intensity, np.float32).reshape(n, 1)], -1)
    else:
        body = xyz
    secs = int(stamp)
    nsecs = int(round((stamp - secs) * 1e9))
    fid = frame_id.encode()
    out = [struct.pack("<III", 0, secs, nsecs),
           struct.pack("<I", len(fid)), fid,
           struct.pack("<II", 1, n),              # height=1, width=n
           struct.pack("<I", len(fields))]
    for name, off, dt, cnt in fields:
        out += [struct.pack("<I", len(name)), name,
                struct.pack("<IBI", off, dt, cnt)]
    raw = body.astype("<f4").tobytes()
    out += [struct.pack("<B", 0),                  # little-endian
            struct.pack("<II", step, step * n),
            struct.pack("<I", len(raw)), raw,
            struct.pack("<B", 1)]                  # is_dense
    return b"".join(out)


def _rpy_to_quat(rpy) -> np.ndarray:
    """ZYX euler -> quaternion (x, y, z, w)."""
    r, p, y = [v / 2 for v in rpy]
    cr, sr, cp, sp, cy, sy = (np.cos(r), np.sin(r), np.cos(p), np.sin(p),
                              np.cos(y), np.sin(y))
    return np.array([
        sr * cp * cy - cr * sp * sy,
        cr * sp * cy + sr * cp * sy,
        cr * cp * sy - sr * sp * cy,
        cr * cp * cy + sr * sp * sy])


def _serialize_imu(stamp: float, frame_id: str, rpy, lin_acc,
                   ang_vel=(0.0, 0.0, 0.0)) -> bytes:
    secs = int(stamp)
    nsecs = int(round((stamp - secs) * 1e9))
    fid = frame_id.encode()
    q = _rpy_to_quat(rpy)
    cov = np.zeros(9, "<f8").tobytes()
    return b"".join([
        struct.pack("<III", 0, secs, nsecs),
        struct.pack("<I", len(fid)), fid,
        np.asarray(q, "<f8").tobytes(), cov,
        np.asarray(ang_vel, "<f8").tobytes(), cov,
        np.asarray(lin_acc, "<f8").tobytes(), cov,
    ])


def write_bag_pointclouds(path: str, clouds, topic: str = "/lslidar_points",
                          frame_id: str = "laser", imu=None,
                          imu_topic: str = "/imu/data") -> None:
    """Write [(stamp, xyz [N,3]) or (stamp, xyz, intensity)] — plus optional
    ``imu`` samples [(stamp, rpy, lin_acc[, ang_vel])] — as a bag with one
    uncompressed chunk, messages merged in stamp order.  Readable by this
    module and by ROS tooling after ``rosbag reindex``."""
    md5 = "1158d486dd51d683ce2f1be655c3c181"   # PointCloud2's well-known md5
    imu_md5 = "6a62c6daae103f4ff57a132d6f95cec2"
    conn = _record(
        {"op": bytes([OP_CONNECTION]), "conn": struct.pack("<I", 0),
         "topic": topic.encode()},
        _header({"topic": topic.encode(), "type": PC2_TYPE.encode(),
                 "md5sum": md5.encode(), "message_definition": b""}))
    if imu:
        conn += _record(
            {"op": bytes([OP_CONNECTION]), "conn": struct.pack("<I", 1),
             "topic": imu_topic.encode()},
            _header({"topic": imu_topic.encode(), "type": IMU_TYPE.encode(),
                     "md5sum": imu_md5.encode(), "message_definition": b""}))

    stream = []
    for item in clouds:
        stamp, xyz = item[0], item[1]
        inten = item[2] if len(item) > 2 else None
        stream.append((stamp, 0, _serialize_pc2(stamp, frame_id, xyz, inten)))
    for item in (imu or []):
        stamp, rpy, acc = item[0], item[1], item[2]
        av = item[3] if len(item) > 3 else (0.0, 0.0, 0.0)
        stream.append((stamp, 1, _serialize_imu(stamp, "imu", rpy, acc, av)))
    stream.sort(key=lambda s: (s[0], s[1]))

    msgs = []
    for stamp, cid, payload in stream:
        secs = int(stamp)
        nsecs = int(round((stamp - secs) * 1e9))
        msgs.append(_record(
            {"op": bytes([OP_MSG]), "conn": struct.pack("<I", cid),
             "time": struct.pack("<II", secs, nsecs)},
            payload))
    blob = conn + b"".join(msgs)
    chunk = _record({"op": bytes([OP_CHUNK]), "compression": b"none",
                     "size": struct.pack("<I", len(blob))}, blob)
    bag_hdr = _record(
        {"op": bytes([OP_BAG_HEADER]), "index_pos": struct.pack("<Q", 0),
         "conn_count": struct.pack("<I", 2 if imu else 1),
         "chunk_count": struct.pack("<I", 1)},
        b" " * 128)                                # spec: padded header record
    with open(path, "wb") as f:
        f.write(MAGIC + bag_hdr + chunk)
