"""ctypes bindings to the port's native C++ runtime (csrc/modkit_native.cpp).

The port's own copy of ``modkit_tpu.native``: it holds what the pileup,
the all-C++ CPU baseline (``cpu_baseline.py``), threshold sampling, the
modBAM rewriters, ``extract``, ``dmr``, ``entropy`` and the measuring tools
(``tools/``) use — BAM record parse + MM/ML/MN decode + per-tile pileup
event extraction, the host threshold/histogram passes, native row formatting,
BGZF compression, CRAM container decode (``cram_decode_container``), the
adjust/call-mods/update-tags span engine (``adjust_stream``), the extract
TSV stream (``extract_full_stream``), the columnar bedMethyl parse
(``parse_bedmethyl_columns``), entropy's window engine (``me_entropy``,
``EntropyBatch``) and the staged decode micro-bench (``bench_decode``) — in
multithreaded C++.

The shared library builds on first use with ``g++`` from the port's own
copy of the runtime, ``modkit_tpu_torch/csrc/modkit_native.cpp`` (the
repository's ``native/modkit_native.cpp`` stays the JAX package's), into
``modkit_tpu_torch/_build/``, under a file name that carries the hash of
the source and flags, so a stale build is never loaded. The copy differs
in its tile decode: each read's alignment is walked as runs clipped to the
tile and its focus, and no-calls are counted in place (``NativeTile``'s
``aligned_columns`` and ``walked_columns`` say how much of the old per-base
walk is left). Set ``MODKIT_TPU_DISABLE_NATIVE=1`` to force the Python path;
it is read on every call, so a run can switch paths within one process.
"""

from __future__ import annotations

import ctypes
import mmap
import os
import subprocess
import threading

import numpy as np

from .sobuild import build_once

_SRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "csrc",
                    "modkit_native.cpp")

# index order must match enum Err in modkit_native.cpp
ERR_KINDS = (
    "MM-tag-missing",
    "ML-tag-missing",
    "invalid-MM-tag",
    "invalid-ML-tag",
    "invalid-MN-tag",
    "non-primary-missing-MN",
    "conflict-probability-greater-than-one",
    "conflict-explicit-prob-and-inferred",
    "no-modified-base-information",
    "invalid-implicit-mode",
)

_lock = threading.Lock()
_lib = None
_load_failed = False

# multi-ref CRAM container ref resolver: const char* (*)(int32 tid,
# int64* len); returns NULL on failure (native falls back to Python)
_REF_CB = ctypes.CFUNCTYPE(
    ctypes.c_void_p, ctypes.c_int32, ctypes.POINTER(ctypes.c_int64)
)


class _MkTileOut(ctypes.Structure):
    _fields_ = [
        ("n_events", ctypes.c_int64),
        ("m", ctypes.c_int32),
        ("ev_rpos", ctypes.POINTER(ctypes.c_int32)),
        ("ev_strand", ctypes.POINTER(ctypes.c_int8)),
        ("ev_base", ctypes.POINTER(ctypes.c_int8)),
        ("ev_probs", ctypes.POINTER(ctypes.c_float)),
        ("nc_counts", ctypes.POINTER(ctypes.c_int32)),
        ("del_counts", ctypes.POINTER(ctypes.c_int32)),
        ("observed", ctypes.POINTER(ctypes.c_uint8)),
        ("vocab", ctypes.POINTER(ctypes.c_int64)),
        ("n_used", ctypes.c_int32),
        ("n_skipped", ctypes.c_int32),
        ("n_nc", ctypes.c_int64),
        ("n_del", ctypes.c_int64),
        ("err_counts", ctypes.c_int64 * 16),
        ("handle", ctypes.c_void_p),
        ("n_parts", ctypes.c_int32),
        ("part_keys", ctypes.POINTER(ctypes.c_char_p)),
        ("aligned_columns", ctypes.c_int64),
        ("walked_columns", ctypes.c_int64),
    ]


class _MkGroupsOut(ctypes.Structure):
    _fields_ = [
        ("rc", ctypes.c_int32),
        ("err_kind", ctypes.c_int32),
        ("n_groups", ctypes.c_int32),
        ("tb", ctypes.POINTER(ctypes.c_int8)),
        ("n_pos", ctypes.POINTER(ctypes.c_int64)),
        ("n_codes", ctypes.POINTER(ctypes.c_int32)),
        ("codes", ctypes.POINTER(ctypes.c_int64)),
        ("probs", ctypes.POINTER(ctypes.c_float)),
        ("total_codes", ctypes.c_int64),
        ("total_probs", ctypes.c_int64),
        ("handle", ctypes.c_void_p),
    ]


class _MkExtractOut(ctypes.Structure):
    _fields_ = [
        ("text", ctypes.c_void_p),
        ("text_len", ctypes.c_int64),
        ("carry", ctypes.c_void_p),
        ("carry_len", ctypes.c_int64),
        ("next_off", ctypes.c_int64),
        ("n_reads", ctypes.c_int32),
        ("eof", ctypes.c_int32),
        ("err_counts", ctypes.c_int64 * 16),
    ]


class _MkAdjustOut(ctypes.Structure):
    _fields_ = [
        ("blob", ctypes.c_void_p),
        ("blob_len", ctypes.c_int64),
        ("carry", ctypes.c_void_p),
        ("carry_len", ctypes.c_int64),
        ("next_off", ctypes.c_int64),
        ("n_written", ctypes.c_int32),
        ("eof", ctypes.c_int32),
        ("err_counts", ctypes.c_int64 * 16),
    ]


_CXX_FLAGS = ["-O3", "-std=c++17", "-fPIC", "-Wall", "-pthread", "-shared"]
# optional accelerators/codecs, dropped one by one when absent:
# libdeflate (htslib's BGZF codec), liblzma (CRAM lzma blocks)
_LINK_CHOICES = (
    ["-ldeflate", "-llzma"],
    ["-ldeflate", "-DMK_NO_LZMA"],
    ["-DMK_NO_LIBDEFLATE", "-llzma"],
    ["-DMK_NO_LIBDEFLATE", "-DMK_NO_LZMA"],
)


def _build(so_path: str) -> None:
    base = [os.environ.get("CXX", "g++"), *_CXX_FLAGS, "-o", so_path, _SRC,
            "-lz"]
    err = b""
    for extra in _LINK_CHOICES:
        try:
            subprocess.run(base + extra, check=True, capture_output=True)
            return
        except subprocess.CalledProcessError as e:
            err = e.stderr
    raise RuntimeError(
        f"failed to build {_SRC}:\n{err.decode(errors='replace')}"
    )


def load():
    """Load (building if needed) the native library; None if unavailable."""
    global _lib, _load_failed
    if os.environ.get("MODKIT_TPU_DISABLE_NATIVE") == "1":
        return None
    if _lib is not None:
        return _lib
    if _load_failed:
        return None
    with _lock:
        if _lib is not None or _load_failed:
            return _lib
        try:
            so = build_once(
                "libmodkit_native", [_SRC],
                [os.environ.get("CXX", "g++"), *_CXX_FLAGS,
                 repr(_LINK_CHOICES)],
                _build,
            )
            lib = ctypes.CDLL(so)
            lib.mk_decode_tile.restype = ctypes.c_int32
            lib.mk_decode_tile.argtypes = [
                ctypes.POINTER(ctypes.c_char_p),      # chunks
                ctypes.POINTER(ctypes.c_int64),       # chunk_lens
                ctypes.c_int32,                       # n_chunks
                ctypes.c_int32,                       # tid
                ctypes.c_int64,                       # start
                ctypes.c_int64,                       # end
                ctypes.c_int64,                       # max_depth
                ctypes.c_int32,                       # force_allow
                ctypes.c_int32,                       # has_edge
                ctypes.c_int64,                       # edge_start
                ctypes.c_int64,                       # edge_end
                ctypes.c_int32,                       # edge_inverted
                ctypes.POINTER(ctypes.c_int64),       # collapse_blob
                ctypes.c_int32,                       # collapse_len
                ctypes.POINTER(ctypes.c_int8),        # focus_rule
                ctypes.c_char_p, ctypes.c_int32,      # ptags, n_ptags
                ctypes.c_int32,                       # n_threads
                ctypes.POINTER(_MkTileOut),
            ]
            lib.mk_free_tile.restype = None
            lib.mk_free_tile.argtypes = [ctypes.POINTER(_MkTileOut)]
            lib.mk_export_events.restype = None
            lib.mk_export_events.argtypes = [
                ctypes.POINTER(_MkTileOut),
                ctypes.c_int64, ctypes.c_int32,
                ctypes.POINTER(ctypes.c_int32),
                ctypes.POINTER(ctypes.c_int32),
                ctypes.POINTER(ctypes.c_int32),
                ctypes.POINTER(ctypes.c_float),
            ]
            lib.mk_export_quals.restype = ctypes.c_int32
            lib.mk_export_quals.argtypes = [
                ctypes.POINTER(_MkTileOut),
                ctypes.c_int64, ctypes.c_int32,
                ctypes.POINTER(ctypes.c_uint8),
                ctypes.POINTER(ctypes.c_uint8),
                ctypes.POINTER(ctypes.c_uint8),
                ctypes.POINTER(ctypes.c_uint8),
            ]
            lib.mk_export_quals_t.restype = ctypes.c_int32
            lib.mk_export_quals_t.argtypes = lib.mk_export_quals.argtypes
            lib.mk_bincount_states.restype = None
            lib.mk_bincount_states.argtypes = [
                ctypes.POINTER(_MkTileOut),
                ctypes.POINTER(ctypes.c_uint8),
                ctypes.c_int32,
                ctypes.POINTER(ctypes.c_int32),
            ]
            lib.mk_bincount_full.restype = None
            lib.mk_bincount_full.argtypes = [
                ctypes.POINTER(_MkTileOut),
                ctypes.POINTER(ctypes.c_uint8),
                ctypes.c_int32,
                ctypes.c_int64,
                ctypes.POINTER(ctypes.c_int32),
            ]
            lib.mk_threshold_states.restype = None
            lib.mk_threshold_states.argtypes = [
                ctypes.POINTER(_MkTileOut),
                ctypes.POINTER(ctypes.c_float),
                ctypes.POINTER(ctypes.c_float),
                ctypes.POINTER(ctypes.c_uint8),
            ]
            lib.mk_format_rows.restype = ctypes.c_int32
            lib.mk_format_rows.argtypes = [
                ctypes.POINTER(ctypes.c_int32),   # counts
                ctypes.c_int64,                   # p
                ctypes.c_int32,                   # k
                ctypes.POINTER(ctypes.c_uint8),   # observed
                ctypes.c_int32,                   # m
                ctypes.POINTER(ctypes.c_char_p),  # labels
                ctypes.POINTER(ctypes.c_int32),   # code_order
                ctypes.c_int64,                   # tile_start
                ctypes.c_char_p,                  # chrom
                ctypes.c_int32,                   # combine_mods
                ctypes.c_char,                    # space char
                ctypes.POINTER(ctypes.c_void_p),  # out buf
                ctypes.POINTER(ctypes.c_int64),   # out len
                ctypes.POINTER(ctypes.c_int64),   # out rows
            ]
            lib.mk_free_buf.restype = None
            lib.mk_free_buf.argtypes = [ctypes.c_void_p]
            lib.mk_extract_span.restype = ctypes.c_int32
            lib.mk_extract_span.argtypes = [
                ctypes.POINTER(ctypes.c_char),
                ctypes.c_int64,                    # raw, raw_len
                ctypes.c_int64, ctypes.c_int64,    # start_off, max_comp
                ctypes.c_char_p, ctypes.c_int64,   # carry, carry_len
                ctypes.c_int32,                    # parse_header
                ctypes.POINTER(ctypes.c_char_p), ctypes.c_int32,
                ctypes.POINTER(ctypes.c_char_p),   # ref_seqs (or None)
                ctypes.POINTER(ctypes.c_int64),    # ref_lens
                ctypes.c_int32,                    # kmer_size
                ctypes.c_int32, ctypes.c_int32,    # mapped_only, allow_np
                ctypes.c_int32, ctypes.c_int64, ctypes.c_int64,
                ctypes.c_int32,                    # edge args
                ctypes.POINTER(ctypes.c_int64), ctypes.c_int32,  # collapse
                ctypes.c_int32, ctypes.c_int32,    # calls_mode, pass_only
                ctypes.c_int32,                    # ignore_implicit
                ctypes.POINTER(ctypes.c_int64),    # pm_codes
                ctypes.POINTER(ctypes.c_double),   # pm_vals
                ctypes.c_int32,                    # n_pm
                ctypes.POINTER(ctypes.c_double),   # fallback_mod4
                ctypes.POINTER(ctypes.c_double),   # can_thr4
                ctypes.c_int32,                    # n_threads
                ctypes.POINTER(_MkExtractOut),
            ]
            lib.mk_free_extract.restype = None
            lib.mk_free_extract.argtypes = [ctypes.POINTER(_MkExtractOut)]
            lib.mk_sample_confidences.restype = ctypes.c_int32
            lib.mk_sample_confidences.argtypes = [
                ctypes.POINTER(ctypes.c_char_p),   # recs
                ctypes.POINTER(ctypes.c_int64),    # lens
                ctypes.POINTER(ctypes.c_uint8),    # only_mapped flags
                ctypes.c_int32,                    # n
                ctypes.c_int32, ctypes.c_int64, ctypes.c_int64,
                ctypes.c_int32,                    # edge args
                ctypes.POINTER(ctypes.c_int64), ctypes.c_int32,  # collapse
                ctypes.c_int32,                    # n_threads
                ctypes.POINTER(ctypes.c_void_p),   # out_conf
                ctypes.POINTER(ctypes.c_void_p),   # out_tb
                ctypes.POINTER(ctypes.c_void_p),   # out_rec
                ctypes.POINTER(ctypes.c_int64),    # out_n
                ctypes.POINTER(ctypes.c_uint8),    # status
            ]
            lib.mk_bench_event_rate.restype = ctypes.c_double
            lib.mk_bench_event_rate.argtypes = [
                ctypes.c_int64, ctypes.c_int32,
            ]
            lib.mk_bench_decode.restype = ctypes.c_double
            lib.mk_bench_decode.argtypes = [
                ctypes.c_char_p, ctypes.c_int64, ctypes.c_int32,
                ctypes.c_int32,
            ]
            lib.mk_decode_tile_bgzf.restype = ctypes.c_int32
            lib.mk_decode_tile_bgzf.argtypes = [
                ctypes.POINTER(ctypes.c_char),
                ctypes.c_int64,                    # raw BAM bytes
                ctypes.POINTER(ctypes.c_int64),    # chunk vbeg
                ctypes.POINTER(ctypes.c_int64),    # chunk vend
                ctypes.c_int32,                    # n_chunks
                ctypes.c_int32,                    # tid
                ctypes.c_int64, ctypes.c_int64,    # start, end
                ctypes.c_int64,                    # max_depth
                ctypes.c_int32,                    # force_allow
                ctypes.c_int32,                    # has_edge
                ctypes.c_int64, ctypes.c_int64,    # edge trims
                ctypes.c_int32,                    # edge inverted
                ctypes.POINTER(ctypes.c_int64),    # collapse blob
                ctypes.c_int32,
                ctypes.POINTER(ctypes.c_int8),     # focus rule
                ctypes.c_char_p, ctypes.c_int32,   # ptags, n_ptags
                ctypes.c_int32,                    # n_threads
                ctypes.POINTER(_MkTileOut),
            ]
            lib.mk_read_groups.restype = ctypes.c_int32
            lib.mk_read_groups.argtypes = [
                ctypes.c_char_p, ctypes.c_int64,   # rec bytes
                ctypes.c_int32,                    # only_mapped
                ctypes.c_int32,                    # has_edge
                ctypes.c_int64, ctypes.c_int64,    # edge trims
                ctypes.c_int32,                    # edge inverted
                ctypes.POINTER(ctypes.c_int64),    # collapse blob
                ctypes.c_int32,
                ctypes.POINTER(_MkGroupsOut),
            ]
            lib.mk_free_groups.restype = None
            lib.mk_free_groups.argtypes = [ctypes.POINTER(_MkGroupsOut)]
            lib.mk_adjust_span.restype = ctypes.c_int32
            lib.mk_adjust_span.argtypes = [
                ctypes.POINTER(ctypes.c_char),
                ctypes.c_int64,                    # raw, raw_len
                ctypes.c_int64, ctypes.c_int64,    # start_off, max_comp
                ctypes.c_char_p, ctypes.c_int64,   # carry, carry_len
                ctypes.c_int32,                    # parse_header
                ctypes.c_int32, ctypes.c_int64, ctypes.c_int64,
                ctypes.c_int32,                    # edge args
                ctypes.POINTER(ctypes.c_int64), ctypes.c_int32,  # collapse
                ctypes.c_int32,                    # caller_mode
                ctypes.POINTER(ctypes.c_int64),    # pm_codes
                ctypes.POINTER(ctypes.c_float),    # pm_vals
                ctypes.c_int32,                    # n_pm
                ctypes.POINTER(ctypes.c_float),    # fallback_mod4
                ctypes.POINTER(ctypes.c_float),    # can_thr4
                ctypes.POINTER(ctypes.c_int64),    # motif blob
                ctypes.c_int32,                    # motif blob len
                ctypes.c_int32,                    # discard_motifs
                ctypes.c_int32,                    # new_mode
                ctypes.c_int32,                    # drop_implicit
                ctypes.c_int32,                    # force_mm_upper
                ctypes.c_int32,                    # compress_level
                ctypes.c_int32,                    # n_threads
                ctypes.POINTER(_MkAdjustOut),
            ]
            lib.mk_free_adjust.restype = None
            lib.mk_free_adjust.argtypes = [ctypes.POINTER(_MkAdjustOut)]
            lib.mk_cram_decode_container.restype = ctypes.c_int32
            lib.mk_cram_decode_container.argtypes = [
                ctypes.POINTER(ctypes.c_char),
                ctypes.c_int64,                    # data, data_len
                ctypes.c_int64,                    # container offset
                ctypes.c_char_p, ctypes.c_int64,   # ref, ref_len
                ctypes.c_char_p, ctypes.c_int64,   # rg blob
                _REF_CB,                           # multi-ref callback
                ctypes.POINTER(ctypes.c_void_p),   # out blob
                ctypes.POINTER(ctypes.c_int64),    # out blob len
                ctypes.POINTER(ctypes.c_int32),    # out n
            ]
            lib.mk_compress_block.restype = ctypes.c_int64
            lib.mk_compress_block.argtypes = [
                ctypes.c_char_p, ctypes.c_int64,
                ctypes.POINTER(ctypes.c_uint8), ctypes.c_int32,
            ]
            lib.mk_sample_region.restype = ctypes.c_int32
            lib.mk_sample_region.argtypes = [
                ctypes.POINTER(ctypes.c_char),
                ctypes.c_int64,                    # raw, raw_len
                ctypes.POINTER(ctypes.c_int64),    # vbeg
                ctypes.POINTER(ctypes.c_int64),    # vend
                ctypes.c_int32,                    # n_chunks
                ctypes.c_int32,                    # tid
                ctypes.c_int64, ctypes.c_int64,    # start, end
                ctypes.c_int64,                    # max_take
                ctypes.c_int32,                    # only_mapped
                ctypes.c_int32, ctypes.c_int64, ctypes.c_int64,
                ctypes.c_int32,                    # edge args
                ctypes.POINTER(ctypes.c_int64), ctypes.c_int32,  # collapse
                ctypes.c_char_p, ctypes.c_int64,   # seen blob
                ctypes.c_int32,                    # n_threads
                ctypes.POINTER(ctypes.c_void_p),   # out_conf
                ctypes.POINTER(ctypes.c_void_p),   # out_tb
                ctypes.POINTER(ctypes.c_int64),    # out_n
                ctypes.POINTER(ctypes.c_void_p),   # out_names
                ctypes.POINTER(ctypes.c_int64),    # out_names_len
                ctypes.POINTER(ctypes.c_int64),    # out_consumed
            ]
            lib.mk_me_entropy.restype = ctypes.c_float
            lib.mk_me_entropy.argtypes = [
                ctypes.c_char_p, ctypes.c_int32, ctypes.c_int32,
                ctypes.c_float,
            ]
            lib.mk_entropy_new.restype = ctypes.c_void_p
            lib.mk_entropy_new.argtypes = [
                ctypes.c_int32, ctypes.c_int32, ctypes.c_int32,
                ctypes.c_int32, ctypes.c_int32,  # route_all
                ctypes.POINTER(ctypes.c_int8),   # plus_base
                ctypes.POINTER(ctypes.c_int64),  # plus_pos
                ctypes.POINTER(ctypes.c_int8),   # minus_base
                ctypes.POINTER(ctypes.c_int64),  # minus_pos
                ctypes.POINTER(ctypes.c_int32),  # plus_present
                ctypes.POINTER(ctypes.c_int32),  # minus_present
                ctypes.POINTER(ctypes.c_int64),  # gates
                ctypes.POINTER(ctypes.c_double),  # can_thr4
                ctypes.POINTER(ctypes.c_double),  # mod_fallback4
                ctypes.POINTER(ctypes.c_int64),  # pm_codes
                ctypes.POINTER(ctypes.c_double),  # pm_thrs
                ctypes.c_int32,                  # n_pm
            ]
            lib.mk_entropy_add.restype = ctypes.c_int32
            lib.mk_entropy_add.argtypes = [
                ctypes.c_void_p,
                ctypes.POINTER(ctypes.c_char), ctypes.c_int64,
                ctypes.POINTER(ctypes.c_int64),
                ctypes.POINTER(ctypes.c_int64), ctypes.c_int32,
                ctypes.c_int32, ctypes.c_int64, ctypes.c_int64,
                ctypes.c_int32,
            ]
            lib.mk_entropy_finish.restype = None
            lib.mk_entropy_finish.argtypes = [
                ctypes.c_void_p, ctypes.c_int32,
                ctypes.POINTER(ctypes.c_int32),
                ctypes.POINTER(ctypes.c_float),
                ctypes.POINTER(ctypes.c_int32),
                ctypes.POINTER(ctypes.c_int32),
                ctypes.POINTER(ctypes.c_float),
                ctypes.POINTER(ctypes.c_int32),
            ]
            lib.mk_entropy_free.restype = None
            lib.mk_entropy_free.argtypes = [ctypes.c_void_p]
            lib.mk_parse_bedmethyl.restype = ctypes.c_int32
            lib.mk_parse_bedmethyl.argtypes = [
                ctypes.c_char_p, ctypes.c_int64,
                ctypes.c_char_p, ctypes.c_int32,
                ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
                ctypes.POINTER(ctypes.c_int64), ctypes.c_int32,
                ctypes.POINTER(ctypes.POINTER(ctypes.c_int64)),
                ctypes.POINTER(ctypes.c_int64),
            ]
            _lib = lib
        except (OSError, RuntimeError):
            _load_failed = True
            return None
    return _lib

def available() -> bool:
    return load() is not None


def as_cbuf(raw):
    """Zero-copy char buffer for the native raw-BAM params: bytes pass
    through; an mmap (ACCESS_COPY, io/bgzf.py) wraps via from_buffer so
    WGS-scale inputs stay file-backed instead of resident."""
    if isinstance(raw, (bytes, bytearray)):
        return raw
    return (ctypes.c_char * len(raw)).from_buffer(raw)


# the largest compressed BGZF block (BSIZE is 16 bits)
BGZF_MAX_BLOCK = 1 << 16


def release_pages(raw, chunks) -> None:
    """Drop a reader's mapping of the pages of the BGZF blocks that a
    native call over ``chunks`` (virtual-offset pairs) has read.

    ``io/bgzf.py`` maps the whole BAM copy-on-write and the native calls
    read it in place, so every page they touch stays mapped, and counted
    in the process's RSS, for the reader's life: over a run the tile
    workers' readers and the estimate's reader map the BAM about twice.
    ``MADV_DONTNEED`` unmaps the pages and leaves them in the page cache;
    the map is never written, so a later touch reads the same bytes from
    the file. The blocks run from the first chunk's start to at most one
    block past the last chunk's end. A ``bytes`` input (stdin) has no map.
    """
    if not isinstance(raw, mmap.mmap) or not chunks:
        return
    lo = min(v for v, _ in chunks) >> 16
    hi = min((max(v for _, v in chunks) >> 16) + BGZF_MAX_BLOCK, len(raw))
    lo -= lo % mmap.PAGESIZE
    if hi > lo:
        raw.madvise(mmap.MADV_DONTNEED, lo, hi - lo)


def bench_event_rate(n_events: int = 1_000_000, m: int = 2) -> float | None:
    """Measured host threshold+count rate (events/s) on a synthetic batch;
    None when the native library is unavailable. Drives the adaptive
    offload policy's host-side cost model (parallel/devices.py)."""
    lib = load()
    if lib is None:
        return None
    return float(lib.mk_bench_event_rate(n_events, m))


def encode_code(code) -> int:
    """ModCode (str char | int ChEBI) -> int64 identity used by native."""
    if isinstance(code, int):
        return code
    return -ord(code)


def decode_code(v: int):
    return int(v) if v >= 0 else chr(-v)


def encode_collapse(methods) -> np.ndarray:
    """Serialize CollapseMethod list to the native int64 blob."""
    blob: list[int] = []
    kinds = {"norm": 0, "dist": 1, "convert": 2}
    for m in methods or ():
        blob.append(kinds[m.kind])
        blob.append(len(m.codes))
        blob.extend(encode_code(c) for c in m.codes)
        blob.append(1 if m.to_code is not None else 0)
        blob.append(encode_code(m.to_code) if m.to_code is not None else 0)
    return np.asarray(blob, dtype=np.int64)


def _ptags_blob(partition_tags) -> bytes | None:
    """Flat 2-char tag bytes for the native partition-key scan."""
    if not partition_tags:
        return None
    blob = b""
    for t in partition_tags:
        tb = str(t).encode()
        if len(tb) != 2:
            raise ValueError(f"partition tag must be 2 chars: {t!r}")
        blob += tb
    return blob


def decode_tile(
    chunks: list[bytes],
    tid: int,
    start: int,
    end: int,
    *,
    max_depth: int = 0,
    force_allow: bool = False,
    edge_filter=None,
    collapse=None,
    focus_rule: np.ndarray | None = None,
    partition_tags: list | None = None,
    n_threads: int | None = None,
):
    """Native tile event decode; returns a dict mirroring the Python
    launch_tile assembly (engine.py:152), or None when native is disabled.

    Keys: rpos/strand/base/probs (sparse mod-call events), nc_counts
    [p,2,4] | None, del_counts [p,2] | None, observed [p,2,4,m] bool,
    vocab (list of ModCode), n_used, n_skipped, errors {kind: count}.
    """
    lib = load()
    if lib is None:
        return None
    n_chunks = len(chunks)
    ChunkArr = ctypes.c_char_p * max(n_chunks, 1)
    LenArr = ctypes.c_int64 * max(n_chunks, 1)
    c_chunks = ChunkArr(*chunks) if n_chunks else ChunkArr()
    c_lens = LenArr(*[len(c) for c in chunks]) if n_chunks else LenArr()

    blob = encode_collapse(collapse)
    c_blob = blob.ctypes.data_as(ctypes.POINTER(ctypes.c_int64))

    if focus_rule is not None:
        fr = np.ascontiguousarray(focus_rule, dtype=np.int8)
        c_rule = fr.ctypes.data_as(ctypes.POINTER(ctypes.c_int8))
    else:
        fr = None
        c_rule = ctypes.POINTER(ctypes.c_int8)()

    has_edge = edge_filter is not None
    out = _MkTileOut()
    nt = n_threads if n_threads is not None else min(os.cpu_count() or 1, 8)
    rc = lib.mk_decode_tile(
        ctypes.cast(c_chunks, ctypes.POINTER(ctypes.c_char_p)),
        ctypes.cast(c_lens, ctypes.POINTER(ctypes.c_int64)),
        n_chunks, tid, start, end, max_depth,
        1 if force_allow else 0,
        1 if has_edge else 0,
        edge_filter.start_trim if has_edge else 0,
        edge_filter.end_trim if has_edge else 0,
        1 if (has_edge and edge_filter.inverted) else 0,
        c_blob, len(blob), c_rule,
        _ptags_blob(partition_tags), len(partition_tags or ()), nt,
        ctypes.byref(out),
    )
    if rc != 0:
        raise RuntimeError(f"mk_decode_tile failed rc={rc}")
    return NativeTile(
        lib, out, (end - start) * max(1, int(out.n_parts)),
        keepalive=(chunks, blob, fr),
    )


def decode_tile_bgzf(
    raw: bytes,
    chunks: list[tuple[int, int]],  # (vbeg, vend) virtual-offset chunks
    tid: int,
    start: int,
    end: int,
    *,
    max_depth: int = 0,
    force_allow: bool = False,
    edge_filter=None,
    collapse=None,
    focus_rule: np.ndarray | None = None,
    partition_tags: list | None = None,
    n_threads: int | None = None,
):
    """Tile decode straight from the compressed BAM bytes: BGZF blocks
    inflate inside the native thread pool with early stop at the first
    record past the tile end (the host feed-ceiling fix — the Python
    fetch path inflated whole BAI chunks, ~2x the tile's share). Output
    is identical to fetch_chunks_raw + decode_tile."""
    lib = load()
    if lib is None:
        return None
    n_chunks = len(chunks)
    vbeg = np.asarray([c[0] for c in chunks], dtype=np.int64)
    vend = np.asarray([c[1] for c in chunks], dtype=np.int64)
    blob = encode_collapse(collapse)
    c_blob = blob.ctypes.data_as(ctypes.POINTER(ctypes.c_int64))
    if focus_rule is not None:
        fr = np.ascontiguousarray(focus_rule, dtype=np.int8)
        c_rule = fr.ctypes.data_as(ctypes.POINTER(ctypes.c_int8))
    else:
        fr = None
        c_rule = ctypes.POINTER(ctypes.c_int8)()
    has_edge = edge_filter is not None
    out = _MkTileOut()
    nt = n_threads if n_threads is not None else min(os.cpu_count() or 1, 8)
    rc = lib.mk_decode_tile_bgzf(
        as_cbuf(raw), len(raw),
        vbeg.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        vend.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        n_chunks, tid, start, end, max_depth,
        1 if force_allow else 0,
        1 if has_edge else 0,
        edge_filter.start_trim if has_edge else 0,
        edge_filter.end_trim if has_edge else 0,
        1 if (has_edge and edge_filter.inverted) else 0,
        c_blob, len(blob), c_rule,
        _ptags_blob(partition_tags), len(partition_tags or ()), nt,
        ctypes.byref(out),
    )
    if rc != 0:
        raise RuntimeError(f"mk_decode_tile_bgzf failed rc={rc}")
    return NativeTile(
        lib, out, (end - start) * max(1, int(out.n_parts)),
        keepalive=(raw, vbeg, vend, blob, fr),
    )


class NativeTile:
    """A decoded tile held in native memory. Sparse events export on demand
    (optionally pre-padded for the device kernel); histograms/metadata copy
    lazily. Dict-style access mirrors the Python assembly for tests."""

    def __init__(self, lib, out, p, keepalive=None):
        self._lib = lib
        self._out = out
        self._p = p
        # --partition-tag: tile-local key list (None = NoKey/"ungrouped");
        # dense arrays fold the key into the position axis
        self.n_parts = max(int(out.n_parts), 1)
        self.part_keys = None
        if out.part_keys and int(out.n_parts) > 0:
            self.part_keys = [
                (
                    out.part_keys[i].decode()
                    if out.part_keys[i] is not None
                    else None
                )
                for i in range(int(out.n_parts))
            ]
        self.n_events = int(out.n_events)
        self.m = max(int(out.m), 1)
        self.n_used = int(out.n_used)
        self.n_skipped = int(out.n_skipped)
        # the aligned columns of the decoded reads, and the columns the walk
        # clipped to the tile (and its focus) visited
        self.aligned_columns = int(out.aligned_columns)
        self.walked_columns = int(out.walked_columns)
        self.errors = {
            ERR_KINDS[i]: int(out.err_counts[i])
            for i in range(len(ERR_KINDS))
            if out.err_counts[i]
        }
        self.vocab = (
            [
                decode_code(v)
                for v in np.ctypeslib.as_array(out.vocab, shape=(out.m,))
            ]
            if out.m and out.vocab
            else []
        )

    def __del__(self):
        out = getattr(self, "_out", None)
        # ctypes may already be torn down at interpreter shutdown
        if out is not None and out.handle and ctypes is not None:
            try:
                self._lib.mk_free_tile(ctypes.byref(out))
            except Exception:
                pass

    def export_events(self, n_pad: int | None = None, m_pad: int | None = None):
        """(rpos_i32, strand_i32, base_i32, probs_f32[n_pad, m_pad]) padded
        exactly as the device kernel expects (zeros / -1 fill)."""
        n = self.n_events
        m = self.m
        n_pad = n if n_pad is None else n_pad
        m_pad = m if m_pad is None else m_pad
        rpos = np.empty(n_pad, dtype=np.int32)
        strand = np.empty(n_pad, dtype=np.int32)
        base = np.empty(n_pad, dtype=np.int32)
        probs = np.empty((n_pad, m_pad), dtype=np.float32)
        self._lib.mk_export_events(
            ctypes.byref(self._out), n_pad, m_pad,
            rpos.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
            strand.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
            base.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
            probs.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        )
        return rpos, strand, base, probs

    def export_quals(self, n_pad: int, m_pad: int):
        """Events-major compact u8 export (quals [n_pad, m_pad], present,
        zero, base), or None when some probability is not an exact
        ML-derived value (collapse / merged sub-tags) or m > 8."""
        u8p = ctypes.POINTER(ctypes.c_uint8)
        quals = np.empty((n_pad, m_pad), dtype=np.uint8)
        present = np.empty(n_pad, dtype=np.uint8)
        zero = np.empty(n_pad, dtype=np.uint8)
        base = np.empty(n_pad, dtype=np.uint8)
        ok = self._lib.mk_export_quals(
            ctypes.byref(self._out), n_pad, m_pad,
            quals.ctypes.data_as(u8p), present.ctypes.data_as(u8p),
            zero.ctypes.data_as(u8p), base.ctypes.data_as(u8p),
        )
        if not ok:
            return None
        return quals, present, zero, base

    def export_quals_t(self, n_pad: int, m_pad: int):
        """Class-major (transposed) compact export for the state kernel
        (ops/state.py); None when probs are not exact ML values or m > 8."""
        u8p = ctypes.POINTER(ctypes.c_uint8)
        quals_t = np.empty((m_pad, n_pad), dtype=np.uint8)
        present = np.empty(n_pad, dtype=np.uint8)
        zero = np.empty(n_pad, dtype=np.uint8)
        base = np.empty(n_pad, dtype=np.uint8)
        ok = self._lib.mk_export_quals_t(
            ctypes.byref(self._out), n_pad, m_pad,
            quals_t.ctypes.data_as(u8p), present.ctypes.data_as(u8p),
            zero.ctypes.data_as(u8p), base.ctypes.data_as(u8p),
        )
        if not ok:
            return None
        return quals_t, present, zero, base

    def threshold_states_cpu(
        self, thr_mod: np.ndarray, thr_can: np.ndarray
    ) -> np.ndarray:
        """Host C++ threshold-call states over this tile's events (the
        pure-CPU baseline path; device kernels are the production path)."""
        states = np.empty(self.n_events, dtype=np.uint8)
        tm = np.ascontiguousarray(thr_mod[: self.m], dtype=np.float32)
        tc = np.ascontiguousarray(thr_can, dtype=np.float32)
        self._lib.mk_threshold_states(
            ctypes.byref(self._out),
            tm.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
            tc.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
            states.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        )
        return states

    def bincount_full(self, states: np.ndarray, m_pad: int) -> np.ndarray:
        """Histogram per-event states straight into the FULL count tensor
        [p, 2, 6 + 4*(m_pad+1)] including the nocall/delete channels —
        one native pass, no numpy zeros/slice copies (assemble_counts
        fast path)."""
        K = 6 + 4 * (m_pad + 1)
        counts = np.empty((self._p, 2, K), dtype=np.int32)
        states = np.ascontiguousarray(states, dtype=np.uint8)
        self._lib.mk_bincount_full(
            ctypes.byref(self._out),
            states.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
            m_pad,
            self._p,
            counts.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        )
        return counts

    def bincount_states(self, states: np.ndarray, m_pad: int) -> np.ndarray:
        """Histogram per-event states into the mod-call count tensor
        [p, 2, 1 + 4*(m_pad+1)] (the CPU baseline's count,
        ``cpu_baseline.py``)."""
        km = 1 + 4 * (m_pad + 1)
        counts = np.zeros((self._p, 2, km), dtype=np.int32)
        states = np.ascontiguousarray(states, dtype=np.uint8)
        self._lib.mk_bincount_states(
            ctypes.byref(self._out),
            states.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
            m_pad,
            counts.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        )
        return counts

    # ---- lazy copies of the dense per-tile outputs ----
    @property
    def nc_counts(self):
        out = self._out
        if not out.nc_counts or out.n_nc == 0:
            return None
        return (
            np.ctypeslib.as_array(out.nc_counts, shape=(self._p * 2 * 4,))
            .copy()
            .reshape(self._p, 2, 4)
        )

    @property
    def del_counts(self):
        out = self._out
        if not out.del_counts or out.n_del == 0:
            return None
        return (
            np.ctypeslib.as_array(out.del_counts, shape=(self._p * 2,))
            .copy()
            .reshape(self._p, 2)
        )

    @property
    def observed(self):
        out = self._out
        m = self.m
        if not out.observed:
            return np.zeros((self._p, 2, 4, m), dtype=bool)
        return (
            np.ctypeslib.as_array(out.observed, shape=(self._p * 2 * 4 * m,))
            .reshape(self._p, 2, 4, m)
            .astype(bool)
        )

    def observed_raw(self):
        """uint8 view of the native observed mask (no copy)."""
        out = self._out
        return np.ctypeslib.as_array(
            out.observed, shape=(self._p, 2, 4, self.m)
        )

    # dict-style access used by the equivalence tests
    def __getitem__(self, key):
        if key in ("rpos", "strand", "base", "probs"):
            rpos, strand, base, probs = self.export_events()
            vals = dict(
                rpos=rpos,
                strand=strand.astype(np.int8),
                base=base.astype(np.int8),
                probs=probs,
            )
            return vals[key]
        return getattr(self, key)


def read_groups(
    rec_raw: bytes,
    only_mapped: bool,
    collapse=None,
    edge_filter=None,
):
    """Per-read probability groups {threshold_base_idx: [(codes, probs)]},
    the native equivalent of thresholds.read_groups. Returns the dict,
    raising ModKitError on undecodable tags; None when native is off."""
    lib = load()
    if lib is None:
        return None
    blob = encode_collapse(collapse)
    out = _MkGroupsOut()
    has_edge = edge_filter is not None
    rc = lib.mk_read_groups(
        rec_raw, len(rec_raw),
        1 if only_mapped else 0,
        1 if has_edge else 0,
        edge_filter.start_trim if has_edge else 0,
        edge_filter.end_trim if has_edge else 0,
        1 if (has_edge and edge_filter.inverted) else 0,
        blob.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        len(blob),
        ctypes.byref(out),
    )
    try:
        if rc != 0:
            from .errors import ModKitError

            raise ModKitError(ERR_KINDS[out.err_kind], "native decode")
        g = out.n_groups
        result: dict[int, list] = {}
        if g == 0:
            return result
        tb = np.ctypeslib.as_array(out.tb, shape=(g,))
        n_pos = np.ctypeslib.as_array(out.n_pos, shape=(g,))
        n_codes = np.ctypeslib.as_array(out.n_codes, shape=(g,))
        codes_flat = (
            np.ctypeslib.as_array(out.codes, shape=(out.total_codes,))
            if out.total_codes
            else np.empty(0, dtype=np.int64)
        )
        probs_flat = (
            np.ctypeslib.as_array(out.probs, shape=(out.total_probs,))
            if out.total_probs
            else np.empty(0, dtype=np.float32)
        )
        cp = pp = 0
        for i in range(g):
            m = int(n_codes[i])
            n = int(n_pos[i])
            codes = [decode_code(v) for v in codes_flat[cp : cp + m]]
            cp += m
            probs = (
                probs_flat[pp : pp + n * m]
                .astype(np.float32, copy=True)
                .reshape(n, m)
            )
            pp += n * m
            result.setdefault(int(tb[i]), []).append((codes, probs))
        return result
    finally:
        lib.mk_free_groups(ctypes.byref(out))


def format_rows(
    counts: np.ndarray,
    observed_u8: np.ndarray,
    labels: list,
    code_order: np.ndarray,
    tile_start: int,
    chrom: str,
    combine_mods: bool,
    space: str,
) -> tuple[bytes, int] | None:
    """Native fused row decode + bedMethyl text formatting (no-focus path).
    Returns (text_bytes, n_rows) or None if native is unavailable."""
    lib = load()
    if lib is None:
        return None
    counts = np.ascontiguousarray(counts, dtype=np.int32)
    observed_u8 = np.ascontiguousarray(observed_u8, dtype=np.uint8)
    p, _, k = counts.shape
    m = observed_u8.shape[3] if observed_u8.ndim == 4 else 0
    label_bytes = [str(c).encode() for c in labels]
    LabelArr = ctypes.c_char_p * max(len(label_bytes), 1)
    c_labels = LabelArr(*label_bytes) if label_bytes else LabelArr()
    order = np.ascontiguousarray(code_order, dtype=np.int32)
    buf = ctypes.c_void_p()
    blen = ctypes.c_int64()
    rows = ctypes.c_int64()
    rc = lib.mk_format_rows(
        counts.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        p, k,
        observed_u8.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        m,
        ctypes.cast(c_labels, ctypes.POINTER(ctypes.c_char_p)),
        order.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        tile_start, chrom.encode(),
        1 if combine_mods else 0,
        space.encode(),
        ctypes.byref(buf), ctypes.byref(blen), ctypes.byref(rows),
    )
    if rc != 0:
        raise RuntimeError("mk_format_rows failed")
    try:
        text = ctypes.string_at(buf.value, blen.value) if blen.value else b""
    finally:
        lib.mk_free_buf(buf)
    return text, int(rows.value)


def sample_confidences_batch(
    raws: list,
    only_mapped_flags: list,
    *,
    collapse=None,
    edge_filter=None,
    n_threads: int | None = None,
):
    """Batched threshold-estimation decode: per-record status (1 = the
    record has mod groups and consumes sampling quota) plus pooled
    (threshold_base, confidence) arrays — one native call for the whole
    chunk (thresholds.py group_confidences semantics). None if native is
    unavailable."""
    lib = load()
    if lib is None:
        return None
    n = len(raws)
    RecArr = ctypes.c_char_p * max(n, 1)
    c_recs = RecArr(*raws)
    lens = np.asarray([len(r) for r in raws] or [0], dtype=np.int64)
    om = np.asarray(only_mapped_flags or [0], dtype=np.uint8)
    blob = encode_collapse(collapse)
    has_edge = edge_filter is not None
    status = np.zeros(max(n, 1), dtype=np.uint8)
    out_conf = ctypes.c_void_p()
    out_tb = ctypes.c_void_p()
    out_rec = ctypes.c_void_p()
    out_n = ctypes.c_int64()
    nt = n_threads if n_threads is not None else min(os.cpu_count() or 1, 8)
    rc = lib.mk_sample_confidences(
        ctypes.cast(c_recs, ctypes.POINTER(ctypes.c_char_p)),
        lens.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        om.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        n,
        1 if has_edge else 0,
        edge_filter.start_trim if has_edge else 0,
        edge_filter.end_trim if has_edge else 0,
        1 if (has_edge and edge_filter.inverted) else 0,
        blob.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)), len(blob),
        nt,
        ctypes.byref(out_conf), ctypes.byref(out_tb),
        ctypes.byref(out_rec), ctypes.byref(out_n),
        status.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
    )
    if rc != 0:
        raise RuntimeError("mk_sample_confidences failed")
    try:
        total = int(out_n.value)
        conf = (
            np.ctypeslib.as_array(
                ctypes.cast(out_conf, ctypes.POINTER(ctypes.c_float)),
                shape=(total,),
            ).copy()
            if total
            else np.empty(0, dtype=np.float32)
        )
        tb = (
            np.ctypeslib.as_array(
                ctypes.cast(out_tb, ctypes.POINTER(ctypes.c_int8)),
                shape=(total,),
            ).copy()
            if total
            else np.empty(0, dtype=np.int8)
        )
        rec_idx = (
            np.ctypeslib.as_array(
                ctypes.cast(out_rec, ctypes.POINTER(ctypes.c_int32)),
                shape=(total,),
            ).copy()
            if total
            else np.empty(0, dtype=np.int32)
        )
    finally:
        lib.mk_free_buf(out_conf)
        lib.mk_free_buf(out_tb)
        lib.mk_free_buf(out_rec)
    return status[:n], conf, tb, rec_idx


def _motif_blob(motifs) -> np.ndarray | None:
    """Serialize sequence motifs as int64 [n, (offset, len, mask...)] with
    4-bit IUPAC base-class masks per position (A=1, C=2, G=4, T=8)."""
    if not motifs:
        return None
    bit = {"A": 1, "C": 2, "G": 4, "T": 8}
    vals: list[int] = [len(motifs)]
    for m in motifs:
        vals.append(int(m.forward_offset))
        classes = m.classes()
        vals.append(len(classes))
        for cl in classes:
            vals.append(sum(bit[c] for c in cl))
    return np.asarray(vals, dtype=np.int64)


def adjust_stream(
    raw: bytes,
    *,
    edge_filter=None,
    collapse=None,
    caller=None,
    filter_only: bool = False,
    motifs=None,
    discard_motifs: bool = False,
    new_mode: str | None = None,
    drop_implicit: bool = False,
    force_mm_style: str | None = None,
    n_threads: int | None = None,
    span_comp_bytes: int = 8 << 20,
    compress_level: int = -1,
):
    """Stream rewritten modBAM records from the compressed BAM bytes.

    Yields (blob, n_written, errors) per ~span_comp_bytes span; ``blob`` is
    a concatenation of ``<i32 len><record bytes>`` items byte-identical to
    the Python engines.adjust.adjust_record_tags path
    (tests/test_native_adjust.py). Reference: src/adjust.rs:211
    adjust_modbam + src/mod_bam.rs:1299 format_mm_ml_tag.
    """
    lib = load()
    if lib is None:
        return
    blob = encode_collapse(collapse)
    c_blob = blob.ctypes.data_as(ctypes.POINTER(ctypes.c_int64))
    has_edge = edge_filter is not None
    nt = n_threads if n_threads is not None else min(os.cpu_count() or 1, 8)

    caller_mode = 0
    pm_codes = np.zeros(1, dtype=np.int64)
    pm_vals = np.zeros(1, dtype=np.float32)
    fb4 = np.zeros(4, dtype=np.float32)
    cn4 = np.zeros(4, dtype=np.float32)
    n_pm = 0
    if caller is not None:
        from .modcodes import DNA_BASES, any_mod_code

        caller_mode = 1 if filter_only else 2
        items = list(caller.per_mod.items())
        n_pm = len(items)
        pm_codes = np.array(
            [encode_code(c) for c, _ in items] or [0], dtype=np.int64
        )
        pm_vals = np.array(
            [float(v) for _, v in items] or [0.0], dtype=np.float32
        )
        for b, base in enumerate(DNA_BASES):
            t = caller.per_mod.get(any_mod_code(base))
            if t is None:
                t = caller.per_base.get(base)
            if t is None:
                t = caller.default_threshold
            fb4[b] = float(t)
            cn4[b] = caller.canonical_threshold(base)

    mblob = _motif_blob(motifs)
    c_mblob = (
        mblob.ctypes.data_as(ctypes.POINTER(ctypes.c_int64))
        if mblob is not None
        else None
    )
    from .modtags import EXPLICIT, IMPLICIT

    nm = -1
    if new_mode == EXPLICIT:
        nm = 0
    elif new_mode == IMPLICIT:
        nm = 1
    elif new_mode is not None:
        nm = 2

    off = 0
    carry = b""
    first = True
    while True:
        out = _MkAdjustOut()
        rc = lib.mk_adjust_span(
            as_cbuf(raw), len(raw), off, span_comp_bytes, carry,
            len(carry),
            1 if first else 0,
            1 if has_edge else 0,
            edge_filter.start_trim if has_edge else 0,
            edge_filter.end_trim if has_edge else 0,
            1 if (has_edge and edge_filter.inverted) else 0,
            c_blob, len(blob),
            caller_mode,
            pm_codes.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
            pm_vals.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
            n_pm,
            fb4.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
            cn4.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
            c_mblob, len(mblob) if mblob is not None else 0,
            1 if discard_motifs else 0,
            nm, 1 if drop_implicit else 0,
            1 if force_mm_style == "MM" else 0,
            compress_level, nt, ctypes.byref(out),
        )
        if rc != 0:
            raise RuntimeError(f"mk_adjust_span failed rc={rc}")
        try:
            data = (
                ctypes.string_at(out.blob, out.blob_len)
                if out.blob_len
                else b""
            )
            carry = (
                ctypes.string_at(out.carry, out.carry_len)
                if out.carry_len
                else b""
            )
            errors = {
                ERR_KINDS[i]: int(out.err_counts[i])
                for i in range(len(ERR_KINDS))
                if out.err_counts[i]
            }
            yield data, int(out.n_written), errors
            eof = bool(out.eof)
            off = out.next_off
        finally:
            lib.mk_free_adjust(ctypes.byref(out))
        first = False
        if eof:
            break


def compress_block(data: bytes, level: int = 6) -> bytes | None:
    """One BGZF block via the native codec (libdeflate when built in);
    None when the native library is unavailable or the block is oversize.
    Used by io.bgzf writers — ctypes drops the GIL, so pooled writer
    threads scale on multi-core hosts."""
    lib = load()
    if lib is None or len(data) > 0xFF00:
        return None
    dst = (ctypes.c_uint8 * 0x10000)()
    n = lib.mk_compress_block(data, len(data), dst, level)
    if n <= 0:
        return None
    return bytes(bytearray(dst)[:n])


def sample_region(
    raw: bytes,
    chunks,
    tid: int,
    start: int,
    end: int,
    max_take: int | None,
    only_mapped: bool,
    seen_blob: bytes,
    *,
    collapse=None,
    edge_filter=None,
    n_threads: int | None = None,
):
    """Count-quota sampling of one merged region entirely in C++
    (thresholds.py sample_reads mapped phase): BGZF inflate + fetch-walk +
    quota/dedup + pooled argmax confidences in one call.

    Returns (conf f32[n], tb i8[n], consumed, new_names_blob) or None when
    the native library is unavailable.
    """
    lib = load()
    if lib is None:
        return None
    n_chunks = len(chunks)
    vbeg = np.asarray([c[0] for c in chunks] or [0], dtype=np.int64)
    vend = np.asarray([c[1] for c in chunks] or [0], dtype=np.int64)
    blob = encode_collapse(collapse)
    has_edge = edge_filter is not None
    nt = n_threads if n_threads is not None else min(os.cpu_count() or 1, 8)
    out_conf = ctypes.c_void_p()
    out_tb = ctypes.c_void_p()
    out_n = ctypes.c_int64()
    out_names = ctypes.c_void_p()
    out_names_len = ctypes.c_int64()
    out_consumed = ctypes.c_int64()
    rc = lib.mk_sample_region(
        as_cbuf(raw), len(raw),
        vbeg.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        vend.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        n_chunks, tid, start, end,
        -1 if max_take is None else max_take,
        1 if only_mapped else 0,
        1 if has_edge else 0,
        edge_filter.start_trim if has_edge else 0,
        edge_filter.end_trim if has_edge else 0,
        1 if (has_edge and edge_filter.inverted) else 0,
        blob.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)), len(blob),
        seen_blob, len(seen_blob), nt,
        ctypes.byref(out_conf), ctypes.byref(out_tb), ctypes.byref(out_n),
        ctypes.byref(out_names), ctypes.byref(out_names_len),
        ctypes.byref(out_consumed),
    )
    if rc != 0:
        raise RuntimeError(f"mk_sample_region failed rc={rc}")
    try:
        total = int(out_n.value)
        conf = (
            np.ctypeslib.as_array(
                ctypes.cast(out_conf, ctypes.POINTER(ctypes.c_float)),
                shape=(total,),
            ).copy()
            if total
            else np.empty(0, dtype=np.float32)
        )
        tb = (
            np.ctypeslib.as_array(
                ctypes.cast(out_tb, ctypes.POINTER(ctypes.c_int8)),
                shape=(total,),
            ).copy()
            if total
            else np.empty(0, dtype=np.int8)
        )
        names = (
            ctypes.string_at(out_names, out_names_len.value)
            if out_names_len.value
            else b""
        )
    finally:
        lib.mk_free_buf(out_conf)
        lib.mk_free_buf(out_tb)
        lib.mk_free_buf(out_names)
    return conf, tb, int(out_consumed.value), names


def cram_decode_container(
    data, off: int, ref: bytes | None, rg_ids: list, get_ref=None
):
    """Decode one CRAM container into raw BAM record buffers (native
    mk_cram_decode_container; mirrors io/cram.py SliceDecoder
    byte-for-byte). Returns a list of record byte strings, or None when
    the native library is unavailable or the container needs the Python
    fallback (unsupported codecs). ``get_ref(tid) -> bytes`` enables
    native multi-reference container decode (per-record RI lookup)."""
    lib = load()
    if lib is None:
        return None
    blob = "\n".join(rg_ids).encode()
    out_blob = ctypes.c_void_p()
    out_len = ctypes.c_int64()
    out_n = ctypes.c_int32()
    keep = {}  # tid -> bytes kept alive for the duration of the call

    if get_ref is not None:
        def _cb(tid, len_ptr):
            try:
                buf = keep.get(tid)
                if buf is None:
                    buf = bytes(get_ref(tid))
                    keep[tid] = buf
                len_ptr[0] = len(buf)
                return ctypes.cast(ctypes.c_char_p(buf), ctypes.c_void_p).value
            except Exception:
                return None

        cb = _REF_CB(_cb)
    else:
        cb = ctypes.cast(None, _REF_CB)
    rc = lib.mk_cram_decode_container(
        as_cbuf(data), len(data), off,
        ref, len(ref) if ref is not None else 0,
        blob, len(blob), cb,
        ctypes.byref(out_blob), ctypes.byref(out_len), ctypes.byref(out_n),
    )
    if rc == 1:
        return None  # python fallback
    if rc != 0:
        raise ValueError(f"corrupt CRAM container at offset {off}")
    try:
        raw = (
            ctypes.string_at(out_blob, out_len.value)
            if out_len.value
            else b""
        )
    finally:
        lib.mk_free_buf(out_blob)
    recs = []
    p = 0
    import struct as _struct

    while p + 4 <= len(raw):
        (n,) = _struct.unpack_from("<i", raw, p)
        recs.append(raw[p + 4 : p + 4 + n])
        p += 4 + n
    return recs


def parse_bedmethyl_columns(
    blob: bytes, chrom: str, qstart: int, qend: int, min_valid: int,
    allowed_codes,
):
    """Columnar bedMethyl parse (native mk_parse_bedmethyl): returns an
    [n, 6] int64 array of (start, code, strand01, n_mod, valid, canon), or
    None when the native library is unavailable."""
    lib = load()
    if lib is None:
        return None
    codes = np.asarray(
        [_encode_mod_code(c) for c in allowed_codes], dtype=np.int64
    )
    out_blob = ctypes.POINTER(ctypes.c_int64)()
    out_n = ctypes.c_int64()
    rc = lib.mk_parse_bedmethyl(
        blob, len(blob), chrom.encode(), len(chrom.encode()),
        qstart, qend, min_valid,
        codes.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)), len(codes),
        ctypes.byref(out_blob), ctypes.byref(out_n),
    )
    if rc != 0:
        return None
    n = out_n.value
    if n == 0:
        return np.zeros((0, 6), dtype=np.int64)
    try:
        arr = np.ctypeslib.as_array(out_blob, shape=(n, 6)).copy()
    finally:
        lib.mk_free_buf(
            ctypes.cast(out_blob, ctypes.POINTER(ctypes.c_char))
        )
    return arr


def _encode_mod_code(code) -> int:
    """Code convention of the native layer: char -> -ord, ChEBI int -> +v."""
    if isinstance(code, int):
        return int(code)
    return -ord(code)


def extract_full_stream(
    raw: bytes,
    tid_names: list,
    *,
    ref_seqs: dict | None = None,
    kmer_size: int = 5,
    mapped_only: bool = False,
    allow_non_primary: bool = False,
    edge_filter=None,
    collapse=None,
    caller=None,
    pass_only: bool = False,
    ignore_implicit: bool = False,
    n_threads: int | None = None,
    span_comp_bytes: int = 8 << 20,
    start_off: int = 0,
    end_off: int | None = None,
    init_carry: bytes = b"",
    parse_header: bool = True,
    tail_data: bytes = b"",
):
    """Stream `extract full`/`extract calls` TSV row blocks from the
    compressed BAM bytes.

    ``start_off``/``end_off`` bound the compressed walk to a block-aligned
    window (multi-host sharding: each rank owns a record-aligned byte
    range); ``init_carry`` seeds the decompressed prefix of the first
    record and ``tail_data`` appends the final partial-block bytes, so a
    rank processes exactly its [voffset_lo, voffset_hi) record slice.

    Yields (text_bytes, n_reads, errors_dict) per ~span_comp_bytes span of
    the compressed stream; rows are byte-identical to the Python
    engines.extract full_rows / calls_rows paths
    (tests/test_native_extract.py). ``ref_seqs`` maps contig NAME -> uint8
    numpy sequence (adds ref_kmer). A non-None ``caller``
    (ThresholdCaller) switches to calls mode.
    """
    lib = load()
    if lib is None:
        return
    n_tids = len(tid_names)
    NameArr = ctypes.c_char_p * max(n_tids, 1)
    c_names = NameArr(*[str(n).encode() for n in tid_names])
    c_refs = None
    c_lens = None
    keep_refs = []
    if ref_seqs is not None:
        c_refs = NameArr()
        lens = np.zeros(max(n_tids, 1), dtype=np.int64)
        for i, name in enumerate(tid_names):
            seq = ref_seqs.get(str(name))
            if seq is None:
                continue
            arr = np.ascontiguousarray(seq, dtype=np.uint8)
            keep_refs.append(arr)
            c_refs[i] = ctypes.cast(
                arr.ctypes.data_as(ctypes.c_void_p), ctypes.c_char_p
            )
            lens[i] = len(arr)
        c_lens = lens.ctypes.data_as(ctypes.POINTER(ctypes.c_int64))
    blob = encode_collapse(collapse)
    c_blob = blob.ctypes.data_as(ctypes.POINTER(ctypes.c_int64))
    has_edge = edge_filter is not None
    nt = n_threads if n_threads is not None else min(os.cpu_count() or 1, 8)

    # calls mode: ThresholdCaller serialized as (per_mod pairs, resolved
    # fallback chain per base, resolved canonical thresholds) in f64 so
    # C++ comparisons promote exactly like np.float32-vs-float Python
    calls_mode = caller is not None
    pm_codes = np.zeros(1, dtype=np.int64)
    pm_vals = np.zeros(1, dtype=np.float64)
    fb4 = np.zeros(4, dtype=np.float64)
    cn4 = np.zeros(4, dtype=np.float64)
    n_pm = 0
    if calls_mode:
        from .modcodes import DNA_BASES, any_mod_code

        items = list(caller.per_mod.items())
        n_pm = len(items)
        pm_codes = np.array(
            [encode_code(c) for c, _ in items] or [0], dtype=np.int64
        )
        pm_vals = np.array(
            [float(v) for _, v in items] or [0.0], dtype=np.float64
        )
        for b, base in enumerate(DNA_BASES):
            t = caller.per_mod.get(any_mod_code(base))
            if t is None:
                t = caller.per_base.get(base)
            if t is None:
                t = caller.default_threshold
            fb4[b] = float(t)
            cn4[b] = caller.canonical_threshold(base)

    off = start_off
    end = len(raw) if end_off is None else end_off
    carry = init_carry
    first = parse_header
    while True:
        out = _MkExtractOut()
        rc = lib.mk_extract_span(
            as_cbuf(raw), end, off, span_comp_bytes, carry, len(carry),
            1 if first else 0, c_names, n_tids, c_refs, c_lens,
            kmer_size, 1 if mapped_only else 0,
            1 if allow_non_primary else 0,
            1 if has_edge else 0,
            edge_filter.start_trim if has_edge else 0,
            edge_filter.end_trim if has_edge else 0,
            1 if (has_edge and edge_filter.inverted) else 0,
            c_blob, len(blob),
            1 if calls_mode else 0, 1 if pass_only else 0,
            1 if ignore_implicit else 0,
            pm_codes.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
            pm_vals.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
            n_pm,
            fb4.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
            cn4.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
            nt, ctypes.byref(out),
        )
        if rc != 0:
            raise RuntimeError(f"mk_extract_span failed rc={rc}")
        try:
            text = (
                ctypes.string_at(out.text, out.text_len)
                if out.text_len
                else b""
            )
            carry = (
                ctypes.string_at(out.carry, out.carry_len)
                if out.carry_len
                else b""
            )
            errors = {
                ERR_KINDS[i]: int(out.err_counts[i])
                for i in range(len(ERR_KINDS))
                if out.err_counts[i]
            }
            yield text, int(out.n_reads), errors
            eof = bool(out.eof)
            off = out.next_off
        finally:
            lib.mk_free_extract(ctypes.byref(out))
        first = False
        if eof:
            break
    if tail_data or (end_off is not None and carry):
        # final partial-block records past the shard's last block boundary
        out = _MkExtractOut()
        final = carry + tail_data
        rc = lib.mk_extract_span(
            b"", 0, 0, 0, final, len(final), 0,
            c_names, n_tids, c_refs, c_lens,
            kmer_size, 1 if mapped_only else 0,
            1 if allow_non_primary else 0,
            1 if has_edge else 0,
            edge_filter.start_trim if has_edge else 0,
            edge_filter.end_trim if has_edge else 0,
            1 if (has_edge and edge_filter.inverted) else 0,
            c_blob, len(blob),
            1 if calls_mode else 0, 1 if pass_only else 0,
            1 if ignore_implicit else 0,
            pm_codes.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
            pm_vals.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
            n_pm,
            fb4.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
            cn4.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
            nt, ctypes.byref(out),
        )
        if rc != 0:
            raise RuntimeError(f"mk_extract_span tail failed rc={rc}")
        try:
            text = (
                ctypes.string_at(out.text, out.text_len)
                if out.text_len
                else b""
            )
            errors = {
                ERR_KINDS[i]: int(out.err_counts[i])
                for i in range(len(ERR_KINDS))
                if out.err_counts[i]
            }
            yield text, int(out.n_reads), errors
        finally:
            lib.mk_free_extract(ctypes.byref(out))


def me_entropy(sequences: list[str], window_size: int, constant: float):
    """Native calc_me_entropy (modkit_native.cpp mk_me_entropy); None if
    the native library is unavailable."""
    lib = load()
    if lib is None:
        return None
    blob = "".join(sequences).encode("ascii")
    return lib.mk_me_entropy(blob, len(sequences), window_size, constant)


class EntropyBatch:
    """Native entropy window-batch engine (mk_entropy_* in
    modkit_native.cpp): decode + threshold calls + pattern assembly +
    per-window entropy in C++. None-able: construct via ``create``."""

    @classmethod
    def create(cls, windows, combine: bool, num_positions: int,
               max_filtered: int, caller, route_all: bool = False):
        lib = load()
        if lib is None:
            return None
        n = len(windows)
        N = num_positions
        plus_base = np.zeros(n * N, dtype=np.int8)
        plus_pos = np.zeros(n * N, dtype=np.int64)
        minus_base = np.zeros(n * N, dtype=np.int8)
        minus_pos = np.zeros(n * N, dtype=np.int64)
        plus_present = np.zeros(n, dtype=np.int32)
        minus_present = np.zeros(n, dtype=np.int32)
        gates = np.full(n * 4, -1, dtype=np.int64)
        for wi, w in enumerate(windows):
            if w.combine:
                # '+'-read keys: pos-side values sorted by position;
                # '-'-read keys: neg keys ordered by their value's position
                items = sorted(
                    w.neg_to_pos.items(), key=lambda kv: kv[1][1]
                )
                pk = [pv for _nk, pv in items]
                mk = [nk for nk, _pv in items]
                iv = w.interval("+")
                gates[wi * 4 + 0], gates[wi * 4 + 1] = iv
                plus_present[wi] = 1
                minus_present[wi] = 1
                for i, (b, p) in enumerate(pk):
                    plus_base[wi * N + i] = ord(b)
                    plus_pos[wi * N + i] = p
                for i, (b, p) in enumerate(mk):
                    minus_base[wi * N + i] = ord(b)
                    minus_pos[wi * N + i] = p
            else:
                if w.pos_positions is not None:
                    iv = w.interval("+")
                    gates[wi * 4 + 0], gates[wi * 4 + 1] = iv
                    plus_present[wi] = 1
                    for i, (b, p) in enumerate(w.pos_positions):
                        plus_base[wi * N + i] = ord(b)
                        plus_pos[wi * N + i] = p
                if w.neg_positions is not None:
                    iv = w.interval("-")
                    gates[wi * 4 + 2], gates[wi * 4 + 3] = iv
                    minus_present[wi] = 1
                    for i, (b, p) in enumerate(w.neg_positions):
                        minus_base[wi * N + i] = ord(b)
                        minus_pos[wi * N + i] = p
        from .modcodes import any_mod_code

        can_thr = np.array(
            [caller.canonical_threshold(b) for b in "ACGT"],
            dtype=np.float64,
        )
        fallback = np.array(
            [
                float(
                    caller.per_mod.get(
                        any_mod_code(b),
                        caller.per_base.get(b, caller.default_threshold),
                    )
                )
                for b in "ACGT"
            ],
            dtype=np.float64,
        )
        pm_codes = np.array(
            [_encode_mod_code(c) for c in caller.per_mod],
            dtype=np.int64,
        )
        pm_thrs = np.array(
            [float(v) for v in caller.per_mod.values()], dtype=np.float64
        )
        i8 = lambda a: a.ctypes.data_as(ctypes.POINTER(ctypes.c_int8))
        i32 = lambda a: a.ctypes.data_as(ctypes.POINTER(ctypes.c_int32))
        i64 = lambda a: a.ctypes.data_as(ctypes.POINTER(ctypes.c_int64))
        f64 = lambda a: a.ctypes.data_as(ctypes.POINTER(ctypes.c_double))
        h = lib.mk_entropy_new(
            n, N, 1 if combine else 0, max_filtered,
            1 if route_all else 0,
            i8(plus_base), i64(plus_pos), i8(minus_base), i64(minus_pos),
            i32(plus_present), i32(minus_present), i64(gates),
            f64(can_thr), f64(fallback),
            i64(pm_codes) if len(pm_codes) else None,
            f64(pm_thrs) if len(pm_thrs) else None, len(pm_codes),
        )
        self = cls()
        self._lib = lib
        self._h = h
        self._n = n
        return self

    def add(self, raw, voffsets, tid: int, lo: int, hi: int,
            n_threads: int = 1) -> None:
        vbeg = np.array([v[0] for v in voffsets], dtype=np.int64)
        vend = np.array([v[1] for v in voffsets], dtype=np.int64)
        self._lib.mk_entropy_add(
            self._h, as_cbuf(raw), len(raw),
            vbeg.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
            vend.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
            len(voffsets), tid, lo, hi, n_threads,
        )

    def finish(self, min_coverage: int):
        n = self._n
        ps = np.zeros(n, dtype=np.int32)
        pm = np.zeros(n, dtype=np.float32)
        pn = np.zeros(n, dtype=np.int32)
        ms = np.zeros(n, dtype=np.int32)
        mm = np.zeros(n, dtype=np.float32)
        mn = np.zeros(n, dtype=np.int32)
        i32 = lambda a: a.ctypes.data_as(ctypes.POINTER(ctypes.c_int32))
        f32 = lambda a: a.ctypes.data_as(ctypes.POINTER(ctypes.c_float))
        self._lib.mk_entropy_finish(
            self._h, min_coverage,
            i32(ps), f32(pm), i32(pn), i32(ms), f32(mm), i32(mn),
        )
        return ps, pm, pn, ms, mm, mn

    def close(self):
        if self._h is not None:
            self._lib.mk_entropy_free(self._h)
            self._h = None

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass


def bench_decode(rec: bytes, reps: int = 2000, stage: int = 4) -> float:
    """Staged single-thread decode micro-bench (native mk_bench_decode) of
    one BAM record ``rec``: stage 0 scan_aux, 1 +forward_seq, 2
    +parse_mm_tag, 3 +decode_read_mods, 4 full decode_read. Returns
    reads/s, 0.0 when the native library is unavailable."""
    lib = load()
    if lib is None:
        return 0.0
    return float(lib.mk_bench_decode(rec, len(rec), reps, stage))
