"""PyTorch + CUDA port of the ``repro`` package (JAX on TPU), slice by slice.

The JAX package under ``src/repro`` is the reference; this package keeps
its module layout and its tensor layouts at public functions, so that the
parity tests compare like with like.  It imports ``torch``, numpy and the
stdlib only: never ``jax`` and never ``repro`` (whose ``__init__`` pulls in
jax).

Ported so far (ROADMAP "Port slices"): every module of the reference
but the JAX-only ones.  The torus all-to-all on ``torch.distributed``
(``core``: ``cart_create`` over a ``DeviceMesh``, ``TorusComm``, the
dense, overlapped, ragged and sparse plans, the chunked async
all-gather and reduce-scatter, the pencil transpose and the KV
migration; autotune, also over other factorizations on subgroups;
tracing, faults, the guideline checker); all ten archs of the reference
(``configs``, with the shape cells and the paper's benchmark config),
served and trained on one device and on a mesh (EP, DP, TP over
``model``, FSDP, Ulysses, ring attention, the pipeline, elastic
recovery, remat policies), the recurrent mixers under Ulysses too; the
encoder-decoder and the stub frontend; disaggregated serving; the
pencil FFT; and the dry run of every shape cell on ``meta`` tensors
(``launch.dryrun``).  Hand-written CUDA kernels for Hopper (``csrc/``)
carry them: the grouped matmul of the expert FFN (also its gradient),
the flash-attention forward (also with ``lse``) and its FlashAttention-2
backward, and the round-k datatype pack/unpack of the factorized
all-to-all.

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``;
without a card they raise instead of falling back.  On CPU tensors every
kernel wrapper takes its plain PyTorch version.
"""
