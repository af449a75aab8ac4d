"""Sequence I/O: FASTA/FASTQ parsing/writing, SAM output, device staging
(the port's counterpart of ``versalignlib_tpu/io``)."""

from versalignlib_tpu_torch.io.fasta import parse_fasta, write_fasta
from versalignlib_tpu_torch.io.fastq import (parse_fastq, parse_sequences, sniff_format,
                                             write_fastq)
from versalignlib_tpu_torch.io.sam import write_sam
from versalignlib_tpu_torch.io.staging import prefetch_to_device

__all__ = [
    "parse_fasta", "write_fasta", "parse_fastq", "write_fastq",
    "parse_sequences", "sniff_format", "write_sam", "prefetch_to_device",
]
