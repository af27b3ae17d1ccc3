"""utils of the PyTorch port: input canonicalisation, batch bucketing, the
build directory, warm-started retries and the compaction model."""

from .bucketing import BucketInfo, bucket_size, pad_to_bucket, unpad
from .cache import enable_compilation_cache
from .shapes import Canon, canon_like, canon_problem
