"""A configuration file's model as one flat dict of the architecture's
numbers, read the same way by the reference and by `counts/`.

Two families of published configuration are read:
- `encodec_hf`: the keys of a Hugging Face `EncodecConfig` (the published
  `facebook/encodec_24khz` config.json);
- `breathing_yaml`: the `model:` section of an experiment YAML of the
  breathing-tokenizer fork (one codebook shared by every stage, no norm
  on the decoder's last conv), with the SEANet's published defaults for
  every key the YAML leaves out.
"""

from __future__ import annotations

import math

SEANET_DEFAULTS = dict(kernel_size=7, last_kernel_size=7,
                       residual_kernel_size=3, dilation_base=2,
                       n_residual_layers=1, compress=2, lstm_layers=2,
                       pad_mode="reflect", true_skip=False,
                       trim_right_ratio=1.0)


def _n_q(bandwidth_kbps: float, sample_rate: int, hop: int) -> int:
    """Stages at a bandwidth: 10 bits per code per frame (the reference's
    hard-coded denominator)."""
    frame_rate = math.ceil(sample_rate / hop)
    return int(1000 * bandwidth_kbps // (frame_rate * 10))


def arch_from_config(cfg_file: dict) -> dict:
    """The architecture of a configuration file (`configs/<name>.json`)."""
    family, c = cfg_file["family"], cfg_file["config"]
    if family == "encodec_hf":
        ratios = list(c["upsampling_ratios"])
        hop = int(math.prod(ratios))
        arch = dict(SEANET_DEFAULTS,
                    channels=c["audio_channels"], dimension=c["hidden_size"],
                    n_filters=c["num_filters"], ratios=ratios,
                    kernel_size=c["kernel_size"],
                    last_kernel_size=c["last_kernel_size"],
                    residual_kernel_size=c["residual_kernel_size"],
                    dilation_base=c["dilation_growth_rate"],
                    n_residual_layers=c["num_residual_layers"],
                    compress=c["compress"], lstm_layers=c["num_lstm_layers"],
                    causal=c["use_causal_conv"], norm=c["norm_type"],
                    decoder_final_norm=c["norm_type"],
                    pad_mode=c["pad_mode"],
                    true_skip=not c["use_conv_shortcut"],
                    trim_right_ratio=c["trim_right_ratio"],
                    bins=c["codebook_size"], shared_codebook=False,
                    sample_rate=c["sampling_rate"],
                    n_q=_n_q(max(c["target_bandwidths"]),
                             c["sampling_rate"], hop))
    elif family == "breathing_yaml":
        m = c["model"]
        ratios = list(m["ratios"])
        hop = int(math.prod(ratios))
        arch = dict(SEANET_DEFAULTS,
                    channels=m["channels"], dimension=m["dimension"],
                    n_filters=m["filters"], ratios=ratios,
                    causal=m["causal"], norm=m["norm"],
                    decoder_final_norm="none", bins=m["bins"],
                    shared_codebook=True, sample_rate=m["sample_rate"],
                    n_q=_n_q(max(m["target_bandwidths"]),
                             m["sample_rate"], hop))
    else:
        raise ValueError(f"unknown configuration family {family!r}")
    arch["hop"] = hop
    arch["frame_rate"] = math.ceil(arch["sample_rate"] / hop)
    return arch
