"""kmcex_tpu_torch — the PyTorch / CUDA port of ``kmcex_tpu``.

Counts canonical k-mers in FASTQ reads on one NVIDIA GPU (spilling to host
RAM and disk when the table outgrows the card, resumable from a
checkpoint), writes and reads KMC databases (KMC1 and KMC2, k up to and
beyond 32), encodes the KModel (Bloom bank + coupled bit arrays + exact rest
store) byte-identical to the JAX package, and answers ``kmer_to_occ`` from
the host or from a model resident on the GPU with identical answers.  The package keeps the JAX
package's layout and module names; it imports ``torch`` and never ``jax``
or ``kmcex_tpu``.

Layer map:
  core/      k-mer math: base LUT, revcomp/canonical and MurmurHash64A on
             int64 tensors, OccuBin count quantizer, the multi-word codec
             (k > 32) and KMC2 minimizer signatures
  io/        FASTQ/FASTA ingestion (native segmenter), the KMC database
             reader and the KMC1 / KMC2 writers
  count/     the counting engine: extract, the hand-written CUDA sort /
             merge / compaction kernels (csrc/) with plain PyTorch versions
             beside them, the device run LSM with its host and disk
             levels and checkpoint, the host accumulator, the pipeline
  model/     KModel build, query and serialization (Bloom bank, rest
             store), the device Bloom-bank build
  query/     DeviceKModel: the model on the GPU, batched kmer_to_occ;
             per-window read annotation from a database or a model
  native/    builds and binds the host C++ runtime and the CUDA kernels
  cli.py     kmcEx-compatible CLI

k-mers travel as int64 tensors holding the raw uint64 bit pattern
(SENTINEL = -1); every order is unsigned.
"""

from kmcex_tpu_torch.config import KParams
from kmcex_tpu_torch.model.kmodel import KModel, get_model, load_model
from kmcex_tpu_torch.query.device_model import DeviceKModel

__version__ = "0.1.0"

__all__ = ["KParams", "KModel", "DeviceKModel", "get_model", "load_model",
           "__version__"]
