"""seaweedfs_tpu_torch — the PyTorch/CUDA port of seaweedfs_tpu.

The port runs the erasure-coding hot path (Reed-Solomon encode and
rebuild of volume files) on an NVIDIA Hopper GPU, behind the storage
layer, the servers and the admin shell that reach it. Its layout mirrors seaweedfs_tpu module for
module, so each file's reference is the file of the same name there;
the port imports nothing from that package.

Layout:
    ops/        GF(256) math, RS matrices, the numpy reference codec,
                the dense torch bit-plane codec (bits, codec_torch) with
                its XOR-schedule chooser (schedule), the native host
                codec (codec_native) and the hand-written CUDA
                coded-matmul kernel (codec_cuda)
    csrc/       CUDA C++ kernel sources, built at first use by ops/_build
    native/     the C++ AVX2 host codec, CRC32C and .dat record walker,
                built with g++ at first use
    ec/         erasure-coding geometry, codec registry and the measured
                router (backend, probe), file encode / rebuild / verify
                and .ecx (encoder), decode back to .dat / .idx (decoder),
                the mounted EC volume (volume)
    storage/    needle records, super block, storage files, needle maps,
                volumes, disk locations, the .vif sidecar, index files,
                and the Store the volume server calls (generate /
                rebuild shards, the degraded-read ladder)
    models/     the batched encode + scrub step
    rpc/        the HTTP transport on the standard library: route
                table and threaded server (http), pooled client that
                follows an HA follower's 307 (httpclient), and the
                websocket of the KeepConnected stream (websocket)
    master/     topology, placement, the file-id sequencers (memory,
                snowflake), raft for HA masters, and the redundancy
                watchdog
    server/     the master (raft-replicated with -peers), the read-only
                master follower, the volume server (data plane by fid,
                EC admin routes, heartbeat to the leader), the filer
                server (namespace, KV, DLM routes) and the in-process
                Cluster
    filer/      entries, chunk algebra, the memory and sqlite metadata
                stores, the event log, per-path rules, the Filer and
                chunked reads over the volume servers
    s3/         the S3 gateway over the filer: SigV4 / V2 auth,
                aws-chunked bodies, buckets, objects and multipart
    wdclient/   the client-side volume and EC-shard location cache
    operation/  client verbs: assign, upload, download, delete
    shell/      the admin shell: ec.encode / ec.rebuild / ec.decode /
                ec.balance / ec.verify, the volume.* commands,
                cluster.ps and cluster.raft.*, the REPL
    cluster/    filer / broker membership the master tracks, and the
                distributed lock manager the filers host
    cli.py      `python -m seaweedfs_tpu_torch
                master|master.follower|volume|filer|s3|server|shell`
    utils/      metrics registry, tracing spans, glog, workload
                sketches, device selection, retry and deadlines, the
                repair token bucket, HTTP range parsing, upload
                compression, header armor

Entry points run on the GPU (device "cuda") unless the caller asks for
the CPU; without a GPU they raise instead of falling back.
"""

__version__ = "0.1.0"
