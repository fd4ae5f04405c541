"""Generic external-binary simulation, the FlowSim pattern (counterpart of
``mlmc_tpu/sim/external.py``).

Re-design of the reference's flow123d workflow (reference
mlmc/tool/flow_mc.py:91-455): each sample renders input templates into its
workspace, runs an external command for the fine and the coarse step, and a
user-supplied extractor parses the outputs into the flattened result
vector. Where FlowSim hard-codes gmsh+flow123d+YAML, this class is the
generic host-side escape hatch for ANY subprocess-based solver — runs under
OneProcessPool/ThreadPool (with workspaces), while device-native
simulations take the DeviceBatchPool/fused paths.

Template placeholders use ``str.format``-style fields; the per-sample
substitutions always include ``step`` (the level's step), ``seed``, and
everything in ``config['parameters']``.

Thread safety: unlike the reference (which chdirs into per-sample
workspaces — a process-global operation that races under ThreadPool), each
sub-sample here runs in its own private temporary directory with absolute
paths, so any pool (threads included) is safe.
"""
import copy
import os
import shutil
import subprocess
import tempfile
from typing import List

import numpy as np

from mlmc_tpu_torch.sim.simulation import Simulation
from mlmc_tpu_torch.quantity.quantity_spec import QuantitySpec
from mlmc_tpu_torch.level_simulation import LevelSimulation


class ExternalCommandSimulation(Simulation):
    """Run an external command per (fine, coarse) sub-sample (private tmp dirs).

    :param config: dict with keys
        command: list of argv elements; each element is format-rendered
            with {step}, {seed}, {input_file}, {output_file}, parameters
        template_file: optional path to an input template rendered into
            the sub-sample tmp dir
        extract_result: callable(output_path, config) -> flat np.ndarray
            (must match result_format)
        result_format: List[QuantitySpec]
        parameters: extra substitutions (must be picklable)
        task_size: relative PBS-style weight per sample (default 0.01)
    """

    INPUT_FILE = "sim_input_{kind}.txt"
    OUTPUT_FILE = "sim_output_{kind}.txt"

    def __init__(self, config):
        super().__init__()
        self._config = dict(config)
        if "template_file" in self._config and self._config["template_file"]:
            self._config["template_file"] = os.path.abspath(
                self._config["template_file"])
        # sub-samples manage their own private tmp dirs (thread-safe);
        # no pool-provided workspace needed
        self.need_workspace = False

    def level_instance(self, fine_level_params: List[float],
                       coarse_level_params: List[float]) -> LevelSimulation:
        config = copy.deepcopy(self._config)
        config["fine_step"] = float(fine_level_params[0])
        config["coarse_step"] = float(coarse_level_params[0])
        config["res_format"] = self.result_format()
        return LevelSimulation(
            config_dict=config,
            task_size=config.get("task_size", 0.01),
            need_sample_workspace=False,
        )

    @staticmethod
    def _render(template_text, subs):
        return template_text.format(**subs)

    @staticmethod
    def _run_one(config, kind, step, seed):
        """Render inputs, run the command in a private tmp dir, extract."""
        work = tempfile.mkdtemp(prefix="mlmc_ext_{}_{}_".format(kind, seed))
        try:
            subs = dict(config.get("parameters", {}))
            input_file = os.path.join(
                work, ExternalCommandSimulation.INPUT_FILE.format(kind=kind))
            output_file = os.path.join(
                work, ExternalCommandSimulation.OUTPUT_FILE.format(kind=kind))
            subs.update(step=step, seed=seed, input_file=input_file,
                        output_file=output_file, work_dir=work)

            template = config.get("template_file")
            if template:
                with open(template) as f:
                    text = f.read()
                with open(input_file, "w") as f:
                    f.write(ExternalCommandSimulation._render(text, subs))

            argv = [ExternalCommandSimulation._render(str(a), subs)
                    for a in config["command"]]
            completed = subprocess.run(argv, capture_output=True, text=True,
                                       cwd=work,
                                       timeout=config.get("timeout", 600))
            if completed.returncode != 0:
                raise RuntimeError(
                    "external command failed (rc={}): {}\nstderr: {}".format(
                        completed.returncode, " ".join(argv),
                        completed.stderr[-1000:]))
            result = np.ravel(np.asarray(
                config["extract_result"](output_file, config), dtype=float))
            return result
        finally:
            shutil.rmtree(work, ignore_errors=True)

    @staticmethod
    def calculate(config, seed):
        fine = ExternalCommandSimulation._run_one(
            config, "fine", config["fine_step"], seed)
        if config["coarse_step"] == 0:
            coarse = np.zeros_like(fine)
        else:
            coarse = ExternalCommandSimulation._run_one(
                config, "coarse", config["coarse_step"], seed)
        expected = int(sum(int(np.prod(q.shape)) * len(q.times) * len(q.locations)
                           for q in config["res_format"]))
        assert fine.size == expected, (fine.size, expected)
        return fine, coarse

    # external binaries have no device batch path
    calculate_batch = None

    def n_ops_estimate(self, step):
        return 1.0 / step

    def result_format(self) -> List[QuantitySpec]:
        return self._config["result_format"]
