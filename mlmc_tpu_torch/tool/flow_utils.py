"""FlowSim-workflow utilities (counterpart of ``mlmc_tpu/tool/flow_utils.py``;
reference mlmc/tool/flow_mc.py helpers): the correlated-field model zoo,
placeholder substitution in templates, and mkdir semantics, kept so
reference workflow scripts port directly.
"""
import os
import re
import shutil

from mlmc_tpu_torch.random.correlated_field import (
    Field,
    Fields,
    SpatialCorrelatedField,
    SpectralCorrelatedField,
)


def create_corr_field(model="gauss", corr_length=0.125, dim=2, log=True,
                      sigma=1, mode_no=1000, seed=None, device=None):
    """Correlated-field model zoo (reference flow_mc.py:16-52): returns a
    Fields instance with a single 'conductivity' field of the given model.

    ``seed`` fixes the spectral mode structure of the RFF variants, making
    a realization fully reproducible from (seed, sampling generator):
    FlowSim derives both from the integer sample seed so renewed samples
    replay bit-identically.

    :param device: where the field is sampled; None = the current CUDA
        device
    """
    if model == "fourier":
        field = SpectralCorrelatedField(corr_exp="gauss", dim=dim,
                                        corr_length=corr_length, log=log,
                                        sigma=sigma, mode_no=mode_no,
                                        seed=seed, device=device)
    elif model in ("exp", "TPLexp"):
        field = SpectralCorrelatedField(corr_exp="exp", dim=dim,
                                        corr_length=corr_length, log=log,
                                        sigma=sigma, mode_no=mode_no,
                                        seed=seed, device=device)
    elif model == "svd":
        field = SpatialCorrelatedField(corr_exp="gauss", dim=dim,
                                       corr_length=corr_length, log=log,
                                       sigma=sigma, device=device)
    else:  # gauss and TPL variants map to the gauss spectral measure
        field = SpectralCorrelatedField(corr_exp="gauss", dim=dim,
                                        corr_length=corr_length, log=log,
                                        sigma=sigma, mode_no=mode_no,
                                        seed=seed, device=device)
    return Fields([Field("conductivity", field)])


def substitute_placeholders(file_in, file_out, params):
    """Substitute ``<name>`` placeholders in a template file
    (reference flow_mc.py:56-74).

    :return: set of placeholder names actually used
    """
    used_params = set()
    with open(file_in) as src:
        text = src.read()

    def repl(match):
        name = match.group(1)
        if name in params:
            used_params.add(name)
            return str(params[name])
        return match.group(0)

    text = re.sub(r"<([a-zA-Z_][a-zA-Z0-9_]*)>", repl, text)
    with open(file_out, "w") as dst:
        dst.write(text)
    return used_params


def force_mkdir(path, force=False):
    """mkdir -p; with force=True remove any existing content first
    (reference flow_mc.py force_mkdir)."""
    if force and os.path.isdir(path):
        shutil.rmtree(path)
    os.makedirs(path, mode=0o775, exist_ok=True)
