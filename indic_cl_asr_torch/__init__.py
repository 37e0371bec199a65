"""indic_cl_asr_torch — the PyTorch + CUDA port of indic_cl_asr_tpu.

This package runs the hybrid RNNT+CTC Conformer on an NVIDIA H100:

  * serving: WAV batch -> log-mel -> Conformer encoder (hand-written flash
    rel-pos attention kernel) -> fused greedy RNNT decode kernel (or
    greedy CTC) -> detokenized hypotheses -> WER;
  * training: log-mel with dither -> SpecAugment -> the encoder in train
    mode (flash attention forward and backward kernels) -> prediction net
    and joint -> chunked RNNT loss over the alpha/beta lattice kernels +
    CTC loss -> AdamW over the trainable parameters (train/step.py).

It imports torch and numpy only, never JAX and nothing of indic_cl_asr_tpu;
the framework-free modules it needs (manifests, tokenizers, WAV IO, WER)
are its own copies. Entry points run on the card by default and raise when
no CUDA device is present unless the caller passes ``device="cpu"``.
"""

from .device import resolve_device

__all__ = ["resolve_device"]
