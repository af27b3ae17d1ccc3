"""utils of the PyTorch port: input canonicalisation, batch bucketing, the
build directory, warm-started retries, the compaction model and staging (a
step captured as one CUDA graph, the counterpart of ``jax.jit``)."""

from .bucketing import BucketInfo, bucket_size, pad_to_bucket, unpad
from .cache import enable_compilation_cache
from .shapes import Canon, canon_like, canon_problem
from .staging import staged
