"""Example scripts of the port, each the counterpart of one of the JAX
package's ``examples/*.py``; run one as ``python -m
dsp_stuff_tpu_torch.examples.<name>`` (the card by default, ``--device
cpu`` for the CPU)."""
