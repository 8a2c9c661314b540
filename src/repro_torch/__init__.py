"""PyTorch + CUDA port of the ``repro`` package (JAX on TPU), slice by slice.

The JAX package under ``src/repro`` is the reference; this package keeps
its module layout and its tensor layouts at public functions, so that the
parity tests compare like with like.  It imports ``torch``, numpy and the
stdlib only: never ``jax`` and never ``repro`` (whose ``__init__`` pulls in
jax).

Ported so far (ROADMAP "Port slices"): the colocated serving path of the
``phi3.5-moe-42b`` config — config, parameter specs, GQA attention with a
ring-buffer KV cache, the capacity-path MoE, the transformer stack,
``ContinuousBatcher`` and the serve launcher — and the torus all-to-all on
``torch.distributed`` (``core``: ``cart_create`` over a ``DeviceMesh``,
``TorusComm``, ``A2APlan``) with the MoE's expert parallelism through it;
and training — the loss, remat, ``make_train_step``, AdamW, the
synthetic data, the checkpoint store, the watchdog, the ``Trainer`` and
the train launcher — on one device and, with expert and data
parallelism, on a ``DeviceMesh`` whose ``model`` dim is 1 (every
collective differentiable).  Hand-written CUDA kernels for Hopper
(``csrc/``) carry them: the grouped matmul of the expert FFN (also its
gradient), the flash-attention forward (also with ``lse``) and its
FlashAttention-2 backward, and the round-k datatype pack/unpack of the
factorized all-to-all.

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``;
without a card they raise instead of falling back.  On CPU tensors every
kernel wrapper takes its plain PyTorch version.
"""
