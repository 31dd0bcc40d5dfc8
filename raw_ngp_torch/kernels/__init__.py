"""Hand-written CUDA kernels for Hopper and their wrappers.

Each wrapper launches its kernel for CUDA tensors and takes the plain
PyTorch version only for CPU tensors. The sources live in
``raw_ngp_torch/csrc/`` and are built on first use (``_build``).

Each wrapper counts, in ``<wrapper>.launches``, the calls that launch its
kernel, where they launch and nowhere else. A train step captured in a
CUDA graph (:mod:`raw_ngp_torch.train.dispatch`) calls its wrappers once,
at capture, where each call records its kernel into the graph and counts
one; every replay launches the recorded kernels again without Python, and
no counter counts them. The launches of replayed steps are counted on the
device, by kernel name, from the profiler's events (:data:`CUDA_KERNELS`
names every ``__global__`` function of the sources).
"""

import re

# the __global__ functions of raw_ngp_torch/csrc, as the profiler names
# their launches (a template's name carries its arguments after a "<")
CUDA_KERNELS = (
    "decimate_count_kernel", "decimate_scan_kernel", "decimate_place_kernel",
    "decimate_bwd_kernel",
    "hash_encode_kernel", "encode_input_grad_kernel",
    "encode_input_jvp_kernel",
    "cell_sums_kernel", "cell_edge_group_kernel", "cell_edge_fixup_kernel",
    "cell_keys_kernel", "cell_gather_kernel",
    "radix_histogram_kernel", "radix_pass_kernel",
    "segsum_channel_kernel", "segsum_outer_kernel", "segsum_flat_walk_kernel",
    "segsum_flat_fixup_kernel", "segsum_flat_join_kernel",
    "segsum_edge_group_kernel", "segsum_edge_fixup_kernel",
)


def kernel_of(event_name: str):
    """The :data:`CUDA_KERNELS` name of a profiler kernel event's name
    (``void hash_encode_kernel<2, true, false>(float const*, ...)``, a
    namespace before it or not), None for a kernel that is not one of
    them."""
    for name in CUDA_KERNELS:
        if re.search(rf"(?<!\w){name}(?=[<(])", event_name):
            return name
    return None
