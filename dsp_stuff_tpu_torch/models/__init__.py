from dsp_stuff_tpu_torch.models.presets import (
    config1_gain_biquad, config2_delay_chorus, config3_oversampled_distortion,
    config4_convolution_reverb, config5_feedback_16node, PRESETS,
)
