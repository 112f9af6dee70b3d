# Compression-aware physical design of a training/serving job's persistent
# tensors under an HBM budget (the layout advisor and its codecs).
from .advisor import (Choice, LayoutPlan, TensorClass, job_tensor_classes,
                      plan_layout, skyline, step_cost)
from .codecs import CODECS, Codec, decode, encode, sample_cf_bytes

__all__ = ["Choice", "LayoutPlan", "TensorClass", "job_tensor_classes",
           "plan_layout", "skyline", "step_cost", "CODECS", "Codec",
           "decode", "encode", "sample_cf_bytes"]
