"""Data parallelism across processes and the mesh over ('data', 'model')
(counterpart of vision_transformer_detector_tpu/parallel/)."""
