"""Gradient fitting of a graph's sliders: train.fit (fit, make_train_step,
make_loss_fn, clamp_params, adam, mse_loss, spectral_loss)."""

from dsp_stuff_tpu_torch.train import fit  # noqa: F401
