"""The ``ss`` extensions (graphblas_tpu/core/ss): ``Matrix.ss`` and
``Vector.ss`` (storage formats, interchange, tiling, order operations,
serialize, scan) and the execution ``Context``."""
