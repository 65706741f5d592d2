"""seaweedfs_tpu_torch — the PyTorch/CUDA port of seaweedfs_tpu.

The port runs the erasure-coding hot path (Reed-Solomon encode and
rebuild of volume files) on an NVIDIA Hopper GPU. Its layout mirrors
seaweedfs_tpu module for module, so each file's reference is the file of
the same name there; the port imports nothing from that package.

Layout:
    ops/        GF(256) math, RS matrices, the numpy reference codec,
                the dense torch bit-plane codec (bits, codec_torch) with
                its XOR-schedule chooser (schedule), the native host
                codec (codec_native) and the hand-written CUDA
                coded-matmul kernel (codec_cuda)
    csrc/       CUDA C++ kernel sources, built at first use by ops/_build
    native/     the C++ AVX2 host codec, built with g++ at first use
    ec/         erasure-coding geometry, codec registry and the measured
                router (backend, probe), file encode / rebuild / verify
                and .ecx (encoder), decode back to .dat / .idx (decoder)
    storage/    the .vif sidecar, index files (types, idx, needle_map),
                needle record sizes
    models/     the batched encode + scrub step
    utils/      metrics registry, tracing spans, glog, device selection

Entry points run on the GPU (device "cuda") unless the caller asks for
the CPU; without a GPU they raise instead of falling back.
"""

__version__ = "0.1.0"
