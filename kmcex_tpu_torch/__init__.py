"""kmcex_tpu_torch — the PyTorch / CUDA port of ``kmcex_tpu``.

Counts canonical k-mers in FASTQ reads on one NVIDIA GPU, writes the KMC1
database, and encodes the KModel (Bloom bank + coupled bit arrays + exact
rest store) byte-identical to the JAX package.  The package keeps the JAX
package's layout and module names; it imports ``torch`` and never ``jax``
or ``kmcex_tpu``.

Layer map:
  core/      k-mer math: base LUT, revcomp/canonical on int64 tensors,
             OccuBin count quantizer
  io/        FASTQ/FASTA ingestion (native segmenter) and the KMC1 writer
  count/     the counting engine: extract, the hand-written CUDA sort /
             merge / compaction kernels (csrc/) with plain PyTorch versions
             beside them, the device run LSM, the CLI pipeline
  model/     KModel build and serialization (Bloom bank, rest store)
  native/    builds and binds the host C++ runtime and the CUDA kernels
  cli.py     kmcEx-compatible CLI

k-mers travel as int64 tensors holding the raw uint64 bit pattern
(SENTINEL = -1); every order is unsigned.
"""

from kmcex_tpu_torch.config import KParams
from kmcex_tpu_torch.model.kmodel import KModel, get_model, load_model

__version__ = "0.1.0"

__all__ = ["KParams", "KModel", "get_model", "load_model", "__version__"]
