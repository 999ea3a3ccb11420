"""Minimal pure-python reader for uncompressed CDF V3 files.

Replaces the reference's ``spacepy.pycdf`` dependency (a C library binding,
reference utils/data_preprocess/human36m.py:8,54) for the one use this
framework has: reading Human3.6M ``D3_Positions_mono`` pose archives (a
single uncompressed float64 zVariable named 'Pose').

Scope: CDF version 3, uncompressed files, zVariables, numeric data types.
Metadata integers are network (big-endian) byte order per the CDF internal
format; the data encoding follows the CDR Encoding field.
"""

from __future__ import annotations

import struct

import numpy as np

_MAGIC_V3 = 0xCDF30001
_MAGIC_UNCOMPRESSED = 0x0000FFFF

# record types
_CDR, _GDR, _RVDR, _VXR, _VVR, _ZVDR, _CVVR = 1, 2, 3, 6, 7, 8, 13

# CDF data type -> numpy dtype char (endianness applied separately)
_DTYPES = {
    1: "i1", 2: "i2", 4: "i4", 8: "i8",
    11: "u1", 12: "u2", 14: "u4",
    21: "f4", 22: "f8", 44: "f4", 45: "f8",
    41: "i1", 51: "S1", 52: "S1",
}

# encodings that are little-endian for data
_LITTLE_ENCODINGS = {6, 13, 16}  # IBMPC, ALPHAOSF1, ALPHAVMSI


class CDFReadError(ValueError):
    pass


def _u4(buf, off):
    return struct.unpack_from(">i", buf, off)[0]


def _u8(buf, off):
    return struct.unpack_from(">q", buf, off)[0]


def read_cdf(path: str) -> dict[str, np.ndarray]:
    """Read all zVariables of an uncompressed CDF v3 file.

    Returns:
      dict name -> array of shape (num_records, *dims).
    """
    with open(path, "rb") as f:
        buf = f.read()

    if struct.unpack_from(">I", buf, 0)[0] != _MAGIC_V3:
        raise CDFReadError(f"{path}: not a CDF v3 file")
    if struct.unpack_from(">I", buf, 4)[0] != _MAGIC_UNCOMPRESSED:
        raise CDFReadError(f"{path}: compressed CDF not supported; "
                           "convert once with spacepy/cdfconvert")

    # CDR directly follows the magic
    cdr_off = 8
    if _u4(buf, cdr_off + 8) != _CDR:
        raise CDFReadError(f"{path}: CDR not found")
    encoding = _u4(buf, cdr_off + 8 + 4 + 8 + 4 + 4)
    data_bo = "<" if encoding in _LITTLE_ENCODINGS else ">"

    gdr_off = _u8(buf, cdr_off + 12)
    if _u4(buf, gdr_off + 8) != _GDR:
        raise CDFReadError(f"{path}: GDR not found")
    # GDR: size(8) type(4) rVDRhead(8) zVDRhead(8) ...
    zvdr_off = _u8(buf, gdr_off + 12 + 8)

    out: dict[str, np.ndarray] = {}
    while zvdr_off:
        out.update(_read_zvar(buf, zvdr_off, data_bo))
        zvdr_off = _u8(buf, zvdr_off + 12)  # VDRnext
    return out


def _read_zvar(buf, off, data_bo):
    if _u4(buf, off + 8) != _ZVDR:
        raise CDFReadError("expected zVDR record")
    p = off + 12
    # VDRnext(8) DataType(4) MaxRec(4) VXRhead(8) VXRtail(8) Flags(4)
    # SRecords(4) rfuB(4) rfuC(4) rfuF(4) NumElems(4) Num(4)
    # CPRorSPRoffset(8) BlockingFactor(4) Name(256) zNumDims(4) ...
    data_type = _u4(buf, p + 8)
    max_rec = _u4(buf, p + 12)
    vxr_head = _u8(buf, p + 16)
    num_elems = _u4(buf, p + 48)
    name_off = p + 8 + 4 + 4 + 8 + 8 + 4 + 4 + 4 + 4 + 4 + 4 + 4 + 8 + 4
    name = buf[name_off:name_off + 256].split(b"\x00")[0].decode(
        "ascii", "replace")
    zdims_off = name_off + 256
    znum_dims = _u4(buf, zdims_off)
    dims = [
        _u4(buf, zdims_off + 4 + 4 * i) for i in range(znum_dims)
    ]

    if data_type not in _DTYPES:
        raise CDFReadError(f"variable {name}: unsupported data type "
                           f"{data_type}")
    dt = np.dtype(data_bo + _DTYPES[data_type])
    if _DTYPES[data_type] == "S1" and num_elems > 1:
        dt = np.dtype(f"S{num_elems}")

    n_records = max_rec + 1
    rec_items = int(np.prod(dims)) if dims else 1
    rec_bytes = rec_items * dt.itemsize

    chunks: list[tuple[int, int, bytes]] = []
    _collect_vxr(buf, vxr_head, rec_bytes, chunks)
    data = np.zeros((max(n_records, 0), *dims), dt)
    flat = data.reshape(max(n_records, 0), -1) if rec_items else data
    for first, last, raw in chunks:
        arr = np.frombuffer(raw, dt, count=(last - first + 1) * rec_items)
        flat[first:last + 1] = arr.reshape(last - first + 1, rec_items)
    return {name: data}


def _collect_vxr(buf, vxr_off, rec_bytes, chunks):
    while vxr_off:
        if _u4(buf, vxr_off + 8) != _VXR:
            raise CDFReadError("expected VXR record")
        p = vxr_off + 12
        nxt = _u8(buf, p)
        n_entries = _u4(buf, p + 8)
        n_used = _u4(buf, p + 12)
        firsts = [_u4(buf, p + 16 + 4 * i) for i in range(n_entries)]
        lasts = [_u4(buf, p + 16 + 4 * n_entries + 4 * i)
                 for i in range(n_entries)]
        offs = [_u8(buf, p + 16 + 8 * n_entries + 8 * i)
                for i in range(n_entries)]
        for i in range(n_used):
            child_type = _u4(buf, offs[i] + 8)
            if child_type == _VVR:
                nrec = lasts[i] - firsts[i] + 1
                raw = buf[offs[i] + 12: offs[i] + 12 + nrec * rec_bytes]
                chunks.append((firsts[i], lasts[i], raw))
            elif child_type == _VXR:
                _collect_vxr(buf, offs[i], rec_bytes, chunks)
            else:
                raise CDFReadError(
                    f"unsupported VXR child record type {child_type} "
                    "(compressed variable?)")
        vxr_off = nxt


# ---------------------------------------------------------------------------
# Writer (testing / fixture generation only)
# ---------------------------------------------------------------------------

def write_cdf(path: str, name: str, data: np.ndarray):
    """Write a single-zVariable uncompressed CDF v3 file (one record per
    leading index).  Only used to build test fixtures for the reader."""
    data = np.ascontiguousarray(data, np.dtype(">f8"))
    n_rec = data.shape[0]
    dims = list(data.shape[1:])
    rec_bytes = int(np.prod(dims, dtype=np.int64)) * 8 if dims else 8

    blobs = []

    def record(rtype, payload):
        size = 12 + len(payload)
        blobs.append((size, struct.pack(">qi", size, rtype) + payload))
        return sum(s for s, _ in blobs[:-1]) + 8  # offset of this record

    # layout: magic(8) CDR GDR zVDR VXR VVR
    # compute offsets iteratively: build payloads with placeholder offsets,
    # then patch.  Simpler: fixed order, compute sizes first.
    cdr_payload_len = 8 + 4 + 4 + 4 + 4 + 4 + 4 + 4 + 4 + 256
    gdr_payload_len = 8 + 8 + 8 + 8 + 4 + 4 + 4 + 4 + 4 + 4 + 8 + 4 + 8
    zvdr_payload_len = (8 + 4 + 4 + 8 + 8 + 4 + 4 + 4 + 4 + 4 + 4 + 4 + 8
                        + 4 + 256 + 4 + 4 * len(dims) + 4 * len(dims))
    vxr_payload_len = 8 + 4 + 4 + 4 + 4 + 8
    vvr_payload_len = n_rec * rec_bytes

    off_cdr = 8
    off_gdr = off_cdr + 12 + cdr_payload_len
    off_zvdr = off_gdr + 12 + gdr_payload_len
    off_vxr = off_zvdr + 12 + zvdr_payload_len
    off_vvr = off_vxr + 12 + vxr_payload_len

    cdr = struct.pack(">qiiiiiiii", off_gdr, 3, 8, 1, 2, 0, 0, 0, 0)
    cdr += b"\x00" * (cdr_payload_len - len(cdr))

    gdr = struct.pack(">qqqq", 0, off_zvdr, 0, 0)          # rVDRhead=0, zVDRhead
    gdr += struct.pack(">iiiiii", 3, 0, 0, 1, 0, 0)        # Version.. NzVars=1
    gdr += struct.pack(">qiq", 0, 0, 0)
    gdr += b"\x00" * (gdr_payload_len - len(gdr))

    zvdr = struct.pack(">q", 0)                            # VDRnext
    zvdr += struct.pack(">ii", 45, n_rec - 1)              # CDF_DOUBLE, MaxRec
    zvdr += struct.pack(">qq", off_vxr, off_vxr)           # VXRhead/tail
    zvdr += struct.pack(">iiiiii", 0, 0, 0, 0, 0, 1)       # flags.. NumElems=1
    zvdr += struct.pack(">i", 0)                           # Num
    zvdr += struct.pack(">qi", 0, 0)                       # CPR offset, blocking
    zvdr += name.encode().ljust(256, b"\x00")
    zvdr += struct.pack(">i", len(dims))
    for d in dims:
        zvdr += struct.pack(">i", d)
    for _ in dims:
        zvdr += struct.pack(">i", -1)                      # DimVarys: VARY

    vxr = struct.pack(">qii", 0, 1, 1)                     # next, N, Nused
    vxr += struct.pack(">ii", 0, n_rec - 1)                # First, Last
    vxr += struct.pack(">q", off_vvr)

    vvr = data.tobytes()

    with open(path, "wb") as f:
        f.write(struct.pack(">II", _MAGIC_V3, _MAGIC_UNCOMPRESSED))
        for rtype, payload in ((1, cdr), (2, gdr), (8, zvdr), (6, vxr),
                               (7, vvr)):
            f.write(struct.pack(">qi", 12 + len(payload), rtype) + payload)
