"""biokanga_tpu_torch — the PyTorch and CUDA port of biokanga_tpu.

A second package beside the JAX one, for one NVIDIA H100.  Module names
mirror biokanga_tpu so each part has an obvious counterpart; the JAX
package stays the reference that every part is tested against, bit for
bit.  This package imports torch and nothing of jax or of biokanga_tpu:
the host modules it needs are copied in, at the same module paths.  Its
hand-written CUDA kernels live in csrc/ and are built on first use
(kernels/); each has a plain torch version beside it that runs for CPU
tensors.

Ported so far: the index build (`index`, chunked, bisulfite and
colorspace too), short-read alignment (`align`: paired ends, single ends
with every option: SNP calls, micro-indels, splice junctions, chimeric
trims, the post-passes, BAM; bisulfite and colorspace reads), PacBio
long-read error correction (`ecreads`, resumable too), `pbfilter` and
`contigs`, de novo assembly (`assemb`, `scaffold`, `pescaffold`), the SW
service (`swservice`), the multi-device layer on torch.distributed
(parallel/: the sharded aligner, multi-host input, `ec_reads(mesh=...)`),
the device tools (`uhamming`, `blitz`, `mergeoverlaps`,
`findapproxmatches`, the marker tools, the simulators), and read
preparation with the host tools: `filter` and `ngsqc` (whose contaminant
vector screen runs the aligner on `--device`), `kangar`, `kangapr`,
`filterreads`, `kmerdist`, the converters, the expression, zygosity and
misc tools, the SQLite loaders, and the chromatin structure,
conservation and GO families (`predconfnucs` and `genstructprofile`
gather their octamer profiles on `--device`): 108 of the JAX CLI's 109
subcommands, all but `eccontigs`.
"""

__version__ = "0.1.0"
