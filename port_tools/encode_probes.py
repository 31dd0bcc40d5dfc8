#!/usr/bin/env python3
"""Probe copies of this tree's raw_ngp_torch/csrc for `chip_smoke.py
--against`, each one change away from the tree, to time what one design
choice of the encode kernels costs:

    python3 port_tools/encode_probes.py VARIANT [TREE]
    python3 chip_smoke.py --against TREE

VARIANT (TREE defaults to workspace/VARIANT):
- one_row: the JVP loads a window's second row only where its weight
  tangent is not 0, so a one-corner window (a level that is not pairable:
  the -O grid's xor levels) loads one row instead of two. Exact only for
  a finite table: the kernel itself loads the row, since JAX forms
  rnd(T * 0), NaN where T is inf or NaN (see for_each_window_tangent in
  csrc/hash_encode.cu). chip_smoke.py's random tables are finite, so its
  `ab` line still checks the bits. The forward is left as it is.
- hw_mod: mod_u32 reduces a divisor that is not a power of two with the
  hardware's `%` sequence instead of the fastmod constants (every kernel;
  the same bits)."""
import os
import shutil
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

PROBE = '''
// (probe) the window's second row read only where its weight is not 0
template <int C>
__device__ __forceinline__ void probe_row(const float* __restrict__ p,
                                          float w, float v[kQuad<C>]) {
  if (w != 0.0f) {
    load_quad<C>(p, v);
  } else {
#pragma unroll
    for (int q = 0; q < kQuad<C>; ++q) v[q] = 0.0f;
  }
}
'''


def one_row(src):
    """The JVP's windows with their second row through probe_row."""
    # probe copies of the two window chains, the second row through
    # probe_row; the JVP kernel calls them, the forward keeps its own
    start = src.index("template <int C>\n__device__ __forceinline__ void "
                      "window_bf16(")
    end = src.index("// One window level of the bf16 forward")
    bf16 = src[start:end].replace("window_bf16(", "window_bf16_probe(")
    start = src.index("template <int C>\n__device__ __forceinline__ void "
                      "window_f32(")
    end = src.index("// One dense (matmul) level of the JVP")
    f32 = src[start:end].replace("window_f32(", "window_f32_probe(")
    second = "load_quad<C>(tq + (int64_t)bb * C + C, tb);"
    assert bf16.count(second) == 1 and f32.count(second) == 1
    probe = PROBE + (bf16 + f32).replace(
        second, "probe_row<C>(tq + (int64_t)bb * C + C, w1, tb);")
    kernel = src.index("encode_input_jvp_kernel(const float*")
    head, tail = src[:kernel], src[kernel:]
    assert "window_bf16<C>(tq, bb, w0, w1, acc);" in tail
    tail = (tail.replace("window_bf16<C>(tq, bb, w0, w1, acc);",
                         "window_bf16_probe<C>(tq, bb, w0, w1, acc);")
            .replace("window_f32<C>(tq, bb, w0, w1, acc);",
                     "window_f32_probe<C>(tq, bb, w0, w1, acc);"))
    decl = head.rindex("template <int C, bool BF16>")
    return head[:decl] + probe + "\n" + head[decl:] + tail


def hw_mod(src):
    """mod_u32 with the hardware's % where d is not a power of two."""
    fastmod = ("  return mask != 0xffffffffu ? x & mask\n"
               "                             : (uint32_t)__umul64hi("
               "magic * x, (uint64_t)d);")
    assert src.count(fastmod) == 1
    return src.replace(fastmod,
                       "  return mask != 0xffffffffu ? x & mask : x % d;")


VARIANTS = {"one_row": one_row, "hw_mod": hw_mod}


def main() -> int:
    if len(sys.argv) not in (2, 3) or sys.argv[1] not in VARIANTS:
        print(__doc__, file=sys.stderr)
        return 2
    variant = sys.argv[1]
    tree = sys.argv[2] if len(sys.argv) > 2 else os.path.join(
        ROOT, "workspace", variant)
    dst = os.path.join(tree, "raw_ngp_torch", "csrc")
    shutil.rmtree(dst, ignore_errors=True)
    shutil.copytree(os.path.join(ROOT, "raw_ngp_torch", "csrc"), dst)
    path = os.path.join(dst, "hash_encode.cu")
    with open(path) as f:
        src = VARIANTS[variant](f.read())
    with open(path, "w") as f:
        f.write(src)
    print(f"encode_probes: wrote {variant} to {path}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
