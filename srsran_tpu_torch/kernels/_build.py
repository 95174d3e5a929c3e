"""Build ``srsran_tpu_torch/csrc/*.cu`` into one shared library at first use.

The kernels have a plain C interface, so ``nvcc`` compiles them without
PyTorch's headers (seconds, not minutes): one ``nvcc -c`` per source, all
started together, then one link, into ``build/kernels/`` at the repository
root, named by a hash of the sources and flags; the library is loaded with
``ctypes``.  A fresh checkout (as ``chip_smoke.py`` runs from) pays the cold
build on every run, so the sources compile side by side.  Pointers and the stream go over as
``ctypes.c_void_p``; every C entry point returns ``cudaGetLastError()``
after its launches, and :func:`check` raises on anything but 0.
:class:`Launch` is the lean form of that path (K1, K3, K4, K5, K6, K7, K8,
K9, K10, K11, K12, K13, K14, K15, K16, K20, K22, K23, K24, K25, K26, K32,
K21, K18, K19, K27, K33, K34 and K35 take it): a
wrapper keeps one per call signature with the bound C function, a
parameter struct passed by address and its device tables, and a call
passes only the tensors' pointers and the current stream.

``--fmad=false`` keeps ``a + b * c`` as a rounded multiply then a rounded
add, the way PyTorch's separate tensor ops compute it: the LDPC decoder's
hard decisions are held bit-exact against its twin.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "--fmad=false", "-Xptxas=-v", "-Xcompiler", "-fPIC")

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_D = ctypes.c_double
_L = ctypes.c_longlong

CONTROL_MAX_PDUS = 16      # csrc/dl_control_map.cu kMaxPdus
CONTROL_PTRS_PER_PDU = 4   # csrc/dl_control_map.cu kPtrsPerPdu


class ControlPdu(ctypes.Structure):
    """csrc/dl_control_map.cu's ControlPdu (one PDCCH or SSB of K27): its
    pointers are filled by the C entry from the call's pointer array."""

    _fields_ = [("bits0", _P), ("bits1", _P), ("bits2", _P), ("pilots", _P),
                ("stride0", _L), ("stride1", _L), ("stride2", _L),
                ("pilot_stride", _L), ("n0", _I), ("n1", _I), ("words", _I),
                ("amplitude", _F)]


class ControlArgs(ctypes.Structure):
    """csrc/dl_control_map.cu's ControlArgs (the kernel's, by value)."""

    _fields_ = [("pdu", ControlPdu * CONTROL_MAX_PDUS), ("npdus", _I),
                ("nitems", _I), ("ntiles", _I), ("nslots", _I), ("P", _I),
                ("S", _I), ("K", _I), ("qpsk", _F), ("grid_stride", _L)]


class ControlParams(ctypes.Structure):
    """csrc/dl_control_map.cu's ControlParams (K27's launch), by address:
    the kernel's arguments and, per PDU, the entries of the call's
    pointer array that fill bits0, bits1, bits2 and pilots (-1: none)."""

    _fields_ = [("args", ControlArgs),
                ("ptr", (_I * CONTROL_PTRS_PER_PDU) * CONTROL_MAX_PDUS)]


class LlrParams(ctypes.Structure):
    """csrc/llr.cu's LlrParams (K35's launch), by address."""

    _fields_ = [("n", _L), ("scale", _F), ("blocks", _I)]


class PolarEncodeParams(ctypes.Structure):
    """csrc/polar_encode.cu's PolarEncodeParams (K33's launch), by
    address."""

    _fields_ = [("B", _I), ("K", _I), ("n", _I), ("E", _I), ("npc", _I),
                ("warps", _I), ("split", _I)]


POLAR_MAX_STEPS = 2048     # csrc/polar_sc.cu kPolarMaxSteps


class PolarDecodeParams(ctypes.Structure):
    """csrc/polar_sc.cu's PolarDecodeParams (K15's launch), by address: the
    sizes, then the node schedule by value."""

    _fields_ = [("B", _I), ("E", _I), ("n", _I), ("K", _I), ("R", _I),
                ("nops", _I), ("warps", _I), ("expect", ctypes.c_uint),
                ("words", ctypes.c_uint * POLAR_MAX_STEPS)]


class ShortBlockEncodeParams(ctypes.Structure):
    """csrc/short_block.cu's ShortBlockEncodeParams (K34's launch), by
    address."""

    _fields_ = [("B", _I), ("K", _I), ("E", _I), ("P", _I), ("warps", _I)]


SB_MAX_PERIOD = 32         # csrc/short_block.cu kSbMaxPeriod


class ShortBlockDetectParams(ctypes.Structure):
    """csrc/short_block.cu's ShortBlockDetectParams (K14's launch), by
    address."""

    _fields_ = [(name, _I) for name in ("B", "K", "E", "Q", "warps", "nk",
                                        "ks", "kt")] + [("sqrt_e", _F)]

LDPC_MAX_ROWS = 46         # csrc/ldpc_decode.cu kLdpcMaxRows
LDPC_MAX_EDGES = 316       # csrc/ldpc_decode.cu kLdpcMaxEdges


class LdpcDecodeParams(ctypes.Structure):
    """csrc/ldpc_decode.cu's LdpcDecodeParams (K1's launch), by address:
    the sizes, the barriers, then the edge tables by value (row pointers;
    per edge an int2: the byte offset of (column, shift) and the first lane
    that wraps, Z - shift)."""

    _fields_ = [("nb", _I), ("cbs_per_slot", _I), ("nslots", _I),
                ("nrows", _I), ("ncols", _I), ("live", _I), ("z", _I),
                ("threads", _I), ("single", _I),
                ("stride", _I), ("k_prime", _I),
                ("sweeps", _I), ("scaling", _F), ("sync", ctypes.c_ulonglong),
                ("row_ptr", ctypes.c_ushort * (LDPC_MAX_ROWS + 1)),
                ("edge", (_I * 2) * LDPC_MAX_EDGES)]


# the kernel reads each edge's int2 as one 8-byte load
assert LdpcDecodeParams.edge.offset % 8 == 0

ENC_MAX_ROWS = 46          # csrc/ldpc_encode.cu kEncMaxRows
ENC_MAX_EDGES = 316        # csrc/ldpc_encode.cu kEncMaxEdges
ENC_CORE_INTS = 28         # csrc/ldpc_encode.cu kEncCoreInts


class DlschEncodeParams(ctypes.Structure):
    """csrc/ldpc_encode.cu's DlschEncodeParams (K5's launch), by address."""

    _fields_ = [("tbs", _I), ("tb_crc_len", _I), ("cb_crc_len", _I),
                ("ppc", _I), ("kb", _I), ("z", _I), ("nw", _I),
                ("ncols", _I), ("nrows", _I), ("ncb", _I), ("nslots", _I),
                ("threads", _I), ("tb_poly", ctypes.c_uint),
                ("cb_poly", ctypes.c_uint), ("core", _I * ENC_CORE_INTS),
                ("row_ptr", ctypes.c_ushort * (ENC_MAX_ROWS + 1)),
                ("edge", ctypes.c_uint * ENC_MAX_EDGES)]

RM_MAX_RUNS = 8            # csrc/rate_match.cu kMaxRuns


class RateMatchParams(ctypes.Structure):
    """csrc/rate_match.cu's RateMatchParams (K32's launch), by address:
    the window plan and the codeblocks' E and first output bit as runs of
    codeblocks of equal E."""

    _fields_ = [("C", _I), ("N", _I), ("e_max", _I), ("qm", _I), ("fs", _I),
                ("fe", _I), ("n_nf", _I), ("k0p", _I), ("runs", _I),
                ("run_end", _I * RM_MAX_RUNS), ("run_e", _I * RM_MAX_RUNS),
                ("run_off", _I * RM_MAX_RUNS)]


class PrachDemodParams(ctypes.Structure):
    """csrc/prach_demod.cu's PrachDemodParams (K21's launch), by address."""

    _fields_ = [("ports", _I), ("row_stride", _I), ("start", _I),
                ("n_u", _I), ("reps", _I), ("l_ra", _I), ("b0", _I),
                ("rt", _I), ("splits", _I), ("split_blocks", _I),
                ("scale", _F)]

FFT_MAX_STAGES = 8         # csrc/dft_s_ofdm.cuh kMaxStages
DEMAP_MAX_LEVELS = 16      # csrc/dft_s_ofdm.cuh kMaxLevels
DEMAP_MAX_NOISE = 64       # csrc/dft_s_ofdm.cuh kMaxNoise (hops x ports)
F3_MAX_DATA_SYMBOLS = 14   # csrc/dft_s_ofdm.cu kMaxDataSymbols
F3_MAX_OCC = 4             # csrc/dft_s_ofdm.cu kMaxOcc


class FftPlan(ctypes.Structure):
    """csrc/dft_s_ofdm.cuh's FftPlan (K18's and K19's IDFT stages, and
    the Stockham form of K4 and K7)."""

    _fields_ = [("M", _I), ("stages", _I), ("radix", _I * FFT_MAX_STAGES),
                ("span", _I * FFT_MAX_STAGES), ("step", _I * FFT_MAX_STAGES),
                ("magic", ctypes.c_uint * FFT_MAX_STAGES), ("scale", _F)]


class TpDemapParams(ctypes.Structure):
    """csrc/dft_s_ofdm.cu's TpDemapParams (K18's launch), by address."""

    _fields_ = [("fft", FftPlan), ("nslots", _I), ("nblocks", _I),
                ("nre", _I), ("P", _I), ("S", _I), ("K", _I), ("T", _I),
                ("Ka", _I), ("H", _I), ("mmse", _I), ("kind", _I),
                ("half", _I), ("threads", _I), ("two_scale", _F),
                ("levels", _F * DEMAP_MAX_LEVELS)]


class F3DemapParams(ctypes.Structure):
    """csrc/dft_s_ofdm.cu's F3DemapParams (K19's launch), by address."""

    _fields_ = [("fft", FftPlan), ("nslots", _I), ("P", _I), ("S", _I),
                ("K", _I), ("sc0", _I), ("n_data", _I), ("occ_len", _I),
                ("kind", _I), ("threads", _I), ("gold_stride", _I),
                ("two_scale", _F), ("data_syms", _I * F3_MAX_DATA_SYMBOLS),
                ("occ_conj", _F * (2 * F3_MAX_OCC)),
                ("levels", _F * DEMAP_MAX_LEVELS)]

MAP_MAX_LEVELS = 16        # csrc/pdsch_map.cu kMapMaxLevels


class MapParams(ctypes.Structure):
    """csrc/pdsch_map.cu's MapParams (K6's and K22's launch), by
    address."""

    _fields_ = [(name, _I) for name in (
        "C", "C0", "n0", "n1", "tiles", "T", "N", "fs", "gap", "n_nf", "k0p",
        "qm", "L", "P", "S", "K", "nre", "prg_size", "prg_base", "w_stride",
        "nslots")] + [("levels", _F * MAP_MAX_LEVELS)]


LXN_MAX_LEVELS = 16        # csrc/pusch_demap.cuh kLxnMaxLevels


class LxnParams(ctypes.Structure):
    """csrc/pusch_demap.cuh's LxnParams (K3's and K16's launch), by
    address."""

    _fields_ = [(name, _I) for name in (
        "nre", "P", "S", "K", "L", "T", "Ka", "sc_off", "kind", "half",
        "rot0", "mmse", "nslots")] + [
        ("two_scale", _F), ("levels", _F * LXN_MAX_LEVELS)]


class PrachDetectParams(ctypes.Structure):
    """csrc/prach_detect.cu's PrachDetectParams (K9's launch), by
    address."""

    _fields_ = [(name, _I) for name in (
        "B", "rows", "L", "half", "N", "V", "roots", "npre", "nz", "live",
        "C", "win", "margin", "search", "nrx", "smem")] + [
        ("threshold", _F), ("span", _F), ("inv_n", _F)] + [
        (name, _I) for name in ("off_tw", "off_wv", "off_w32", "off_geom",
                                "off_range")]

OFDM_MAX_SYMBOLS = 14      # csrc/ofdm.cuh kOfdmMaxSymbols
OFDM_MAX_STAGES = 3        # csrc/ofdm.cuh kOfdmMaxStages


class OfdmParams(ctypes.Structure):
    """csrc/ofdm.cuh's OfdmParams (K4's and K7's launch), by address."""

    _fields_ = [(name, _I) for name in (
        "rows", "S", "N", "K", "half", "T", "off", "form")] + [
        ("tw_off", _I * (OFDM_MAX_STAGES - 1)),
        ("smem", _I), ("ramp", _I), ("start", _I * OFDM_MAX_SYMBOLS),
        ("cp", _I * OFDM_MAX_SYMBOLS), ("comp", _F * (2 * OFDM_MAX_SYMBOLS)),
        ("fft", FftPlan)]

CHEST_MAX_SYMBOLS = 14     # csrc/channel_estimate.cu kChestMaxSymbols
CHEST_MAX_CTAS = 8         # csrc/channel_estimate.cu kChestMaxCtas


class ChestParams(ctypes.Structure):
    """csrc/channel_estimate.cu's ChestParams (K8's launch), by address."""

    _fields_ = [(name, _I) for name in (
        "P", "L", "S", "K", "Ksm", "cdm", "nsc", "W", "nsym_grid",
        "nsc_grid", "nsym_out", "interp", "use_cfo", "nslots",
        "shared_pilots", "G", "chunk", "M", "maxd", "nfft", "lg_s",
        "smem")] + [
        ("beta", _F), ("beta2", _F), ("two_pi_dt", _F), ("span", _F),
        ("syms", _I * CHEST_MAX_SYMBOLS), ("times", _F * CHEST_MAX_SYMBOLS),
        ("td_i0", _I * CHEST_MAX_SYMBOLS), ("td_w", _F * CHEST_MAX_SYMBOLS)]

F1_MAX_PORTS = 8          # csrc/pucch_f1.cu kF1MaxPorts
F1_MAX_SYMBOLS = 14       # csrc/pucch_f1.cu kF1MaxSymbols
F1_MAX_USERS = 64         # csrc/pucch_f1.cu kF1MaxUsers


class F1Hop(ctypes.Structure):
    """csrc/pucch_f1.cu's F1Hop (one hop of K10's occasion)."""

    _fields_ = [(name, _I) for name in ("prb", "l_lo", "ns", "s0", "n_dm",
                                        "first")]


class F1Params(ctypes.Structure):
    """csrc/pucch_f1.cu's F1Params (K10's launch), by address."""

    _fields_ = [(name, _I) for name in (
        "slots", "U", "P", "nhops", "nsym", "S", "K", "stacked", "n_data",
        "threads")] + [("threshold", _F), ("hop", F1Hop * 2)]


F0_MAX_PORTS = 8          # csrc/pucch_f0.cu kF0MaxPorts
F0_MAX_CANDIDATES = 8     # csrc/pucch_f0.cu kF0MaxCandidates


class F0Params(ctypes.Structure):
    """csrc/pucch_f0.cu's F0Params (K12's launch), by address."""

    _fields_ = [(name, _I) for name in (
        "slots", "P", "S", "C", "nb", "lg", "passes", "nsym", "nsc", "l0",
        "sc0", "sc1", "refs_stride")] + [("maps", ctypes.c_uint),
                                         ("threshold", _F)]


F2_MAX_PORTS = 8          # csrc/pucch_f2.cu kF2MaxPorts
F2_GOLD_WORDS = 17        # csrc/pucch_f2.cu kF2GoldWords


class F2DemapParams(ctypes.Structure):
    """csrc/pucch_f2.cu's F2DemapParams (K13's launch), by address."""

    _fields_ = [(name, _I) for name in (
        "slots", "P", "S", "K", "nd", "nsym", "l0", "sc0", "nsc",
        "threads")] + [("level", _F),
                       ("gold", ctypes.c_uint * F2_GOLD_WORDS)]

SRS_MAX_RX_PORTS = 16     # csrc/srs_estimate.cu kSrsMaxRxPorts
SRS_MAX_LAYERS = 8        # csrc/srs_estimate.cu kSrsMaxLayers
SRS_MAX_SYMBOLS = 4       # csrc/srs_estimate.cu kSrsMaxSymbols
SRS_MAX_WARPS = 8         # csrc/srs_estimate.cu kSrsMaxWarps


class SrsNoiseParams(ctypes.Structure):
    """csrc/srs_estimate.cu's SrsNoiseParams (K11's launch), by address."""

    _fields_ = [(name, _I) for name in (
        "slots", "P", "nsym", "nsc", "sc0", "comb", "s0", "S", "K", "L",
        "lw", "ppc", "J", "ta_stride", "rsrp_stride")] + [
        ("c", _F), ("inv_sk", _F), ("sdof", _F)]


DMRS_MAX_LAYERS = 4       # csrc/dl_rs_map.cu kMaxLayers
DMRS_MAX_SYMBOLS = 4      # csrc/dl_rs_map.cu kMaxDmrsSymbols
DMRS_MAX_PORTS = 8        # csrc/dl_rs_map.cu kDmrsMaxPorts


class DmrsMapParams(ctypes.Structure):
    """csrc/dl_rs_map.cu's DmrsMapParams (K26's launch), by address."""

    _fields_ = [(name, _I) for name in (
        "nslots", "P", "S", "K", "nprb", "npairs", "L", "ports", "type2",
        "prb0", "contiguous", "wkind", "prg_shift", "prg_size", "prg_base",
        "npil", "pilot_stride", "w_stride")] + [
        ("symbols", _I * DMRS_MAX_SYMBOLS)]

RS_MAX_SOURCES = 32       # csrc/dl_rs_map.cu kMaxSources
RS_MAX_RANKS = 16         # csrc/dl_rs_map.cu kRsMaxRanks
RS_INDEX_BITS = 27        # csrc/dl_rs_map.cu kRsIndexBits


class RsMapParams(ctypes.Structure):
    """csrc/dl_rs_map.cu's RsMapParams (K25's launch), by address."""

    _fields_ = [(name, _I) for name in (
        "ntgt", "nslots", "grid_stride", "nranks", "nsrc")] + [
        ("rank_n", _I * RS_MAX_RANKS), ("rank_base", _I * RS_MAX_RANKS),
        ("stride", _I * RS_MAX_SOURCES)]

TDL_MAX_TX = 8            # csrc/tdl_channel.cu kMaxTx
TDL_MAX_TAPS = 16         # csrc/tdl_channel.cu kMaxTaps
TDL_MAX_WARPS = 16        # csrc/tdl_channel.cu kTdlMaxWarps
TDL_MAX_SMEM = 49152      # csrc/tdl_channel.cu kTdlMaxSmem


class TdlParams(ctypes.Structure):
    """csrc/tdl_channel.cu's TdlParams (K20's launch), by address."""

    _fields_ = [(name, _I) for name in (
        "R", "T", "S", "K", "D", "V", "lanes", "runs", "splits", "warps",
        "use_rot", "nblocks", "smem")] + [("scale", _D)]

BFP_MAX_TILES = 1024      # csrc/bfp.cu kBfpMaxTiles
BFP_TILE_PRBS = 32        # csrc/bfp.cu kBfpTilePrbs
BFP_PRB_BITS = 22         # csrc/bfp.cu kBfpPrbBits


class BfpCompressParams(ctypes.Structure):
    """csrc/bfp.cu's BfpCompressParams (K23's launch), by address."""

    _fields_ = [("nblocks", _I), ("width", _I)]


class BfpTile(ctypes.Structure):
    """csrc/bfp.cu's BfpTile: a run of at most BFP_TILE_PRBS PRBs of one
    section (its first record's byte offset; its first flat PRB | (n - 1)
    << 22 | (width - 1) << 27)."""

    _fields_ = [("start", _I), ("word", _I)]


class BfpSectionsParams(ctypes.Structure):
    """csrc/bfp.cu's BfpSectionsParams (K24's launch), by address."""

    _fields_ = [("ntiles", _I), ("buf_len", _I),
                ("tiles", BfpTile * BFP_MAX_TILES)]


class BfpExpandParams(ctypes.Structure):
    """csrc/bfp.cu's BfpExpandParams (K24's (exp, mant) launch)."""

    _fields_ = [("nblocks", _I)]


# C entry points and their argument types (see the matching .cu file).
SIGNATURES = {
    "srsran_ldpc_decode": [_P] * 7,
    "srsran_rate_dematch": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I,
                            _I, _I, _F, _P],
    "srsran_pusch_demap": [_P] * 10,
    "srsran_pusch_demap_lxn": [_P] * 10,
    "srsran_ulsch_demux": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _P, _I, _P],
    "srsran_ofdm_demod_prepare": [_I],
    "srsran_ofdm_demodulate": [_P] * 5,
    "srsran_dlsch_encode": [_P] * 7,
    "srsran_pdsch_map": [_P] * 8,
    "srsran_ofdm_mod_prepare": [_I],
    "srsran_ofdm_modulate": [_P] * 5,
    "srsran_chest_prepare": [_I],
    "srsran_chest_estimate": [_P] * 10,
    "srsran_prach_prepare": [_I],
    "srsran_prach_detect": [_P] * 7,
    "srsran_pucch_f1": [_P] * 13,
    "srsran_srs_noise": [_P] * 7,
    "srsran_pucch_f0": [_P] * 8,
    "srsran_pucch_f2_demap": [_P] * 6,
    "srsran_short_block_detect": [_P] * 6,
    "srsran_short_block_encode": [_P] * 5,
    "srsran_polar_encode": [_P] * 7,
    "srsran_llr_quantize": [_P] * 4,
    "srsran_llr_dequantize": [_P] * 4,
    "srsran_ldpc_parity": [_P, _I, _I, _I, _I, _P, _P, _P, _P, _P],
    "srsran_polar_decode": [_P] * 6,
    "srsran_pusch_tp_demap": [_P] * 11,
    "srsran_pucch_f3_demap": [_P] * 8,
    "srsran_tdl_channel": [_P] * 10,
    "srsran_prach_demod": [_P, _P, _P, _P, _P, _P],
    "srsran_bfp_compress": [_P] * 6,
    "srsran_bfp_decompress_sections": [_P] * 4,
    "srsran_bfp_decompress": [_P] * 5,
    "srsran_rs_map": [_P] * 5,
    "srsran_dmrs_map": [_P] * 6,
    "srsran_control_map": [_P] * 8,
    "srsran_control_llrs": [_P, _P, _P, _I, _P, _P, _I, _F, _P, _P],
    "srsran_polar_scl": [_P, _I, _I, _I, _P, _I, _P, _P, _I, _I, _I, _P, _P,
                         _P],
    "srsran_rate_match": [_P, _P, _P, _P],
    "srsran_cfo": [_P, _L, _I, _F, _L, _P, _P],
    "srsran_amplitude": [_P, _L, _F, _F, _P, _P, _P, _P, _P, _P],
}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    for root in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if root and Path(root, "bin", "nvcc").exists():
            return str(Path(root, "bin", "nvcc"))
    raise RuntimeError("srsran_tpu_torch: nvcc not found (PATH, $CUDA_HOME "
                       "or /usr/local/cuda); the CUDA kernels cannot be built")


def _sources() -> list[Path]:
    return sorted(CSRC.glob("*.cu")) + sorted(CSRC.glob("*.cuh"))


def library_path() -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in _sources():
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"libsrsran_kernels_{h.hexdigest()[:16]}.so"


@functools.lru_cache(maxsize=1)
def load() -> ctypes.CDLL:
    """Build (if needed) and load the kernel library; cached per process."""
    out = library_path()
    t0 = time.perf_counter()
    if not out.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tag = f"{out.stem}.{os.getpid()}"
        nvcc = _nvcc()
        objs, procs = [], []
        for src in sorted(CSRC.glob("*.cu")):
            obj = BUILD_DIR / f"{tag}.{src.stem}.o"
            cmd = [nvcc, *NVCC_FLAGS, "-c", "-o", str(obj), str(src)]
            objs.append(obj)
            procs.append((cmd, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True)))
        outputs = [proc.communicate()[0] for _, proc in procs]  # wait for all
        logs = [_finish(cmd, proc, o) for (cmd, proc), o in zip(procs, outputs)]
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        link = [nvcc, "-gencode", "arch=compute_90a,code=sm_90a", "-shared",
                "-o", str(tmp), *[str(o) for o in objs]]
        proc = subprocess.run(link, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
        logs.append(_finish(link, proc, proc.stdout))
        for obj in objs:
            obj.unlink()
        os.replace(tmp, out)
        out.with_suffix(".log").write_text("".join(logs))
    lib = _bind(ctypes.CDLL(str(out)))
    load.build_seconds = time.perf_counter() - t0
    return lib


def _bind(lib):
    """``lib`` with every entry point of :data:`SIGNATURES` typed."""
    for name, argtypes in SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return lib


@functools.lru_cache(maxsize=1)
def load_locked() -> ctypes.PyDLL:
    """The kernel library through ``ctypes.PyDLL``, for :class:`Launch`:
    its calls keep the interpreter lock, where a ``CDLL`` call releases it
    and must take it back (from another thread, if one is waiting) for a
    launch that takes a few µs.  Built by :func:`load` if needed."""
    load()
    return _bind(ctypes.PyDLL(str(library_path())))


def _finish(cmd: list, proc, output: str) -> str:
    """One finished nvcc's output; raises with it when nvcc failed."""
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n"
                           f"{' '.join(cmd)}\n{output}")
    return output


def build_log() -> str:
    """nvcc's output for the current library (registers, spills), if built."""
    log = library_path().with_suffix(".log")
    return log.read_text() if log.exists() else ""


def check(err: int, what: str) -> None:
    """Raise when a C entry point reported a CUDA error."""
    if err != 0:
        raise RuntimeError(f"{what}: CUDA error {err} at launch")


def ptr(t) -> ctypes.c_void_p:
    return ctypes.c_void_p(t.data_ptr())


def stream_of(t) -> ctypes.c_void_p:
    import torch
    return ctypes.c_void_p(torch.cuda.current_stream(t.device).cuda_stream)


class Launch:
    """One C entry point bound to one call signature of its wrapper.

    A wrapper builds one per signature (its hashable scalars, the inputs'
    shapes and dtypes, and the CUDA device ``index``) in a
    ``functools.lru_cache`` and keeps in it what does not change from call
    to call: the bound C function, a ctypes parameter struct (passed by
    address; the kernel takes its copy by value at launch, so a captured
    CUDA graph holds the values) and the device tables the kernel reads,
    which the plan holds, so nothing it launches with is freed while it
    lives.  A call passes only what changes: the tensors' data pointers,
    then the device's current stream (read per call, so graph capture on a
    side stream sees its own), through one ctypes call that keeps the
    interpreter lock (:func:`load_locked`), and the C entry's return is
    checked.  Entry points take ``(pointers..., stream, params,
    tables...)``.
    """

    __slots__ = ("fn", "name", "index", "tail", "params", "tables",
                 "_stream")

    def __init__(self, name: str, index: int, params: ctypes.Structure,
                 tables: tuple = ()):
        import torch
        self.fn = getattr(load_locked(), name)
        self.name = name
        self.index = index
        self.params = params
        self.tables = tables
        self.tail = (ctypes.addressof(params),) + tuple(
            t.data_ptr() for t in tables)
        self._stream = torch._C._cuda_getCurrentRawStream

    def __call__(self, *ptrs: int) -> None:
        err = self.fn(*ptrs, self._stream(self.index), *self.tail)
        if err:
            raise RuntimeError(f"{self.name}: CUDA error {err} at launch")
