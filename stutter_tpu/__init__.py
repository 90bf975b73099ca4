"""stutter_tpu: a JAX speech-dysfluency recognition framework.

A from-scratch rebuild of the capabilities of
kishormb/Recognizing-Speech-Dysfluencies-in-Stuttering (see SURVEY.md):
audio denoising, librosa-parity DSP feature extraction, dysfluency
classification (jitted MLP/CNN/CNN-BiLSTM/transformer heads; RF/SVM host
baselines), evaluation/reporting, caching, and serving.

Public surface (lazily imported; `import stutter_tpu as st`):

  st.PipelineConfig, st.FEATURES_149, st.FEATURES_334   configuration
  st.extract_features_149_batch / _numpy                 the device front end
  st.denoise_clips / st.denoise_batch                    spectral gate
  st.Predictor / st.SeqPredictor / st.EnsemblePredictor  serving
  st.run_cv / st.run_before_after / st.preprocess        pipeline drivers
  st.fit_mlp / st.cross_validate_mlp                     training engine
  st.cross_validate_seq / st.nested_weighted_vote        seq heads + stacking
"""

__version__ = "0.1.0"

_LAZY = {
    "PipelineConfig": ("stutter_tpu.config", "PipelineConfig"),
    "FEATURES_149": ("stutter_tpu.config", "FEATURES_149"),
    "FEATURES_334": ("stutter_tpu.config", "FEATURES_334"),
    "extract_features_149_batch": ("stutter_tpu.ops.frontend", "extract_features_149_batch"),
    "extract_features_149_numpy": ("stutter_tpu.ops.frontend", "extract_features_149_numpy"),
    "extract_features_334_batch": ("stutter_tpu.ops.frontend334", "extract_features_334_batch"),
    "denoise_clips": ("stutter_tpu.denoise", "denoise_clips"),
    "denoise_batch": ("stutter_tpu.denoise", "denoise_batch"),
    "Predictor": ("stutter_tpu.infer", "Predictor"),
    "SeqPredictor": ("stutter_tpu.infer", "SeqPredictor"),
    "EnsemblePredictor": ("stutter_tpu.infer", "EnsemblePredictor"),
    "cross_validate_seq": ("stutter_tpu.train.seq_pipeline", "cross_validate_seq"),
    "nested_weighted_vote": ("stutter_tpu.train.ensemble", "nested_weighted_vote"),
    "run_cv": ("stutter_tpu.pipeline", "run_cv"),
    "run_before_after": ("stutter_tpu.pipeline", "run_before_after"),
    "preprocess": ("stutter_tpu.pipeline", "preprocess"),
    "extract_corpus": ("stutter_tpu.pipeline", "extract_corpus"),
    "fit_mlp": ("stutter_tpu.train.trainer", "fit_mlp"),
    "cross_validate_mlp": ("stutter_tpu.train.trainer", "cross_validate_mlp"),
    "StandardScaler": ("stutter_tpu.models.scaler", "StandardScaler"),
    "LabelEncoder": ("stutter_tpu.models.scaler", "LabelEncoder"),
}

__all__ = ["__version__", *_LAZY]


def __getattr__(name: str):
    if name in _LAZY:
        import importlib

        module, attr = _LAZY[name]
        return getattr(importlib.import_module(module), attr)
    raise AttributeError(f"module 'stutter_tpu' has no attribute {name!r}")
