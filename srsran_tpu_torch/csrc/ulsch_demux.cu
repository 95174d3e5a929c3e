// K17: the UL-SCH / UCI demultiplexer over the descrambled codeword LLRs,
// for Hopper.
//
// Replaces the field gathers of srsran_tpu/phy/upper/pusch.py::
// decode_from_llrs (:312-340) and their placeholder repair
// (_repair_placeholders, :227-251), planned by srsran_tpu/ops/
// ulsch_demux.py (field_positions :165, placeholder_bit_classes :120).
// Twin: srsran_tpu_torch/ops/uci_demux.py::demux_ref.
//
// Design.  One thread per output bit: out[i] = llr[src[i]] times a sign from
// cls[i] and the slot's Gold bits -- 0: as is; 1 ('x' placeholder, never
// scrambled by the UE): the uniform descramble undone, -1 where c[src] = 1;
// 2 ('y' placeholder, scrambled with the previous bit's c): -1 where
// c[src] ^ c[src - 1] = 1; 3 (a data bit under a punctured HARQ-ACK RE): 0.
// The output holds ACK | CSI1 | CSI2 | data back to back, so the data part
// goes to the rate dematcher and the UCI parts to their decoders as views.
// A slot axis (the slot-batch mode) is more rows: blockIdx.y picks the slot,
// whose codeword LLRs lie at a stride of E; the plan and the Gold bits are
// shared (the scrambling c_init does not depend on the slot).  The output
// is field-major -- each field's B rows back to back, ACK [B, n_ack] |
// CSI1 [B, n_csi1] | CSI2 [B, n_csi2] | data [B, n_data] -- so every field
// is a contiguous [B, n] view for its decoder (with one slot this is the
// unbatched layout).
// The plan (src int32, cls int8) depends only on the PUSCH geometry and UCI
// sizes, not on c_init, and is uploaded once per configuration.  A gather and
// a sign flip: bit-exact against the twin.
//
// Bounds on this card: memory -- per output bit it reads one int32, one
// int8, one f32 and at most two Gold bytes, and writes one f32; at the
// 1-layer QAM16 UE of the two-UE slot (33,792 bits) about 0.5 MB, some
// 0.15 us at 3.35 TB/s.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

struct Fields {
  int end[3];                        // ends of the ACK, CSI1 and CSI2 bits
};

__global__ void ulsch_demux_kernel(const float* __restrict__ llr,
                                   const int* __restrict__ src,
                                   const int8_t* __restrict__ cls,
                                   const uint8_t* __restrict__ seq, int n,
                                   int e, Fields f,
                                   float* __restrict__ out) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const int b = blockIdx.y;                          // slot
  const int nslots = gridDim.y;
  int base = 0, end = n;                             // output bit i's field
  for (int j = 0; j < 3; ++j) {
    if (i < f.end[j]) {
      end = f.end[j];
      break;
    }
    base = f.end[j];
  }
  llr += (size_t)b * e;
  const int s = src[i];
  const int c = cls[i];
  float v = llr[s];
  if (c == 3)
    v = 0.f;
  else if (c == 1 && seq[s])
    v = -v;
  else if (c == 2 && (seq[s] ^ seq[s - 1]))
    v = -v;
  out[(size_t)base * nslots + (size_t)b * (end - base) + (i - base)] = v;
}

}  // namespace

extern "C" int srsran_ulsch_demux(void* llr, void* src, void* cls, void* seq,
                                  int n, int e, int n_ack, int n_csi1,
                                  int n_csi2, void* out, int nslots,
                                  void* stream) {
  if (nslots < 1 || n_ack < 0 || n_csi1 < 0 || n_csi2 < 0 ||
      n_ack + n_csi1 + n_csi2 > n)
    return (int)cudaErrorInvalidValue;
  if (n <= 0) return 0;
  const int threads = 256;
  const dim3 blocks((n + threads - 1) / threads, nslots);
  const Fields f{{n_ack, n_ack + n_csi1, n_ack + n_csi1 + n_csi2}};
  ulsch_demux_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(
      (const float*)llr, (const int*)src, (const int8_t*)cls,
      (const uint8_t*)seq, n, e, f, (float*)out);
  return (int)cudaGetLastError();
}
