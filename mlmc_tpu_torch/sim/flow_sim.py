"""Groundwater-flow MLMC simulation over external gmsh + flow123d binaries
(counterpart of ``mlmc_tpu/sim/flow_sim.py``).

Same workflow capability as the reference's flagship production simulation
(reference mlmc/tool/flow_mc.py:91-455): per level a gmsh mesh is built once
into a shared common-files directory and the flow123d YAML template is
rendered against it; per sample a correlated conductivity field is drawn on
the fine+coarse element centers jointly (the level-coupling trick), written
as a gmsh ``$ElementData`` file, and flow123d is invoked; the QoI is the
total outflow flux from the water-balance output.

Departures from the reference:

* **No chdir, no cwd-relative paths.** Each (fine|coarse) solver run gets a
  private scratch directory and absolute paths (the reference chdirs into
  sample workspaces, which races under thread pools — see sim/external.py).
* **Field draws use an explicit generator** seeded by the integer sample
  seed, so a renewed sample replays bit-identically. The joint fine +
  coarse field is computed on the device ``calculate(config, seed,
  device)`` is given (None: the current CUDA device) and brought to the
  host for the ``$ElementData`` file.
* **Mesh extraction is vectorized** (one pass building arrays, not
  per-element Python appends).

The external binaries are configurable commands, so the whole workflow is
testable with mock executables — the reference ships this path untested
outside a PBS cluster. Meshes are parsed by the native parser
(``native/gmsh_fast.cpp``) where it builds, else by ``GmshIO``;
``FlowSim.parsers`` counts which one parsed.
"""
import os
import shutil
import subprocess
from typing import List

import numpy as np

import torch

from mlmc_tpu_torch.device import resolve_device
from mlmc_tpu_torch.level_simulation import LevelSimulation
from mlmc_tpu_torch.quantity.quantity_spec import QuantitySpec
from mlmc_tpu_torch.sim.simulation import Simulation
from mlmc_tpu_torch.tool.gmsh_io import GmshIO
from mlmc_tpu_torch.tool.flow_utils import (create_corr_field, force_mkdir,
                                            substitute_placeholders)


class FlowSim(Simulation):
    """Darcy-flow sample = gmsh mesh + random conductivity + flow123d solve.

    :param config: dict with keys
        env:            {'gmsh': cmd, 'flow123d': cmd, 'gmsh_version': 2}
        fields_params:  kwargs for tool.flow_utils.create_corr_field
        yaml_file:      flow123d main-input template with <placeholders>
        geo_file:       gmsh geometry file
        field_template: YAML snippet for one field (default FieldElementwise)
        work_dir:       level common-files live under this directory
        time_factor:    scales the <timestep_h1>/<timestep_h2> placeholders
    :param clean: rebuild meshes and rendered YAML even if present
    """

    MESH_FILE_VAR = "mesh_file"
    TIMESTEP_H1_VAR = "timestep_h1"
    TIMESTEP_H2_VAR = "timestep_h2"

    GEO_FILE = "mesh.geo"
    MESH_FILE = "mesh.msh"
    YAML_TEMPLATE = "flow_input.yaml.tmpl"
    YAML_FILE = "flow_input.yaml"
    FIELDS_FILE = "fields_sample.msh"

    #: reference heuristic: ~17e6 mesh points saturate one batch job
    JOB_WEIGHT = 17_000_000

    @staticmethod
    def _resolve_cmd(cmd):
        """Pin a command to an absolute path: solver runs use per-sample
        scratch cwds, where relative paths would no longer resolve."""
        if os.path.sep in cmd:
            return os.path.abspath(cmd)
        found = shutil.which(cmd)
        return found or cmd

    def __init__(self, config, clean=False):
        super().__init__()
        self.need_workspace = True
        self._env = dict(config["env"])
        for key in ("gmsh", "flow123d"):
            self._env[key] = self._resolve_cmd(str(self._env[key]))
        self._fields_params = dict(config["fields_params"])
        # the field names only: no draw is made here
        self._fields = create_corr_field(device="cpu", **self._fields_params)
        self._fields_used = None
        self._time_factor = float(config.get("time_factor", 1.0))
        self._yaml_src = os.path.abspath(config["yaml_file"])
        self._geo_src = os.path.abspath(config["geo_file"])
        self._field_template = config.get(
            "field_template",
            "!FieldElementwise {mesh_data_file: $INPUT_DIR$/%s, field_name: %s}")
        self._work_dir = os.path.abspath(config["work_dir"])
        self._clean = bool(clean)

    # ------------------------------------------------------------------ #
    # level setup (runs once, on the scheduling host)
    # ------------------------------------------------------------------ #
    def _common_dir(self, step):
        return os.path.join(self._work_dir,
                            "l_step_{}_common_files".format(step))

    def _build_level_files(self, step, common_dir):
        """Mesh the geometry at resolution ``step`` and render the solver
        input against it (skipped when the files already exist)."""
        mesh_file = os.path.join(common_dir, self.MESH_FILE)
        yaml_file = os.path.join(common_dir, self.YAML_FILE)
        if not self._clean and os.path.isfile(mesh_file) \
                and os.path.isfile(yaml_file):
            return mesh_file

        geo_file = os.path.join(common_dir, self.GEO_FILE)
        shutil.copyfile(self._geo_src, geo_file)
        argv = [self._env["gmsh"], "-2"]
        if int(self._env.get("gmsh_version", 2)) == 2:
            argv += ["-format", "msh2"]
        argv += ["-clscale", str(step), "-o", mesh_file, geo_file]
        subprocess.run(argv, check=True, capture_output=True)

        template = os.path.join(common_dir, self.YAML_TEMPLATE)
        shutil.copyfile(self._yaml_src, template)
        substitutions = {
            self.MESH_FILE_VAR: mesh_file,
            self.TIMESTEP_H1_VAR: self._time_factor * step,
            self.TIMESTEP_H2_VAR: self._time_factor * step * step,
        }
        for name in self._fields.names:
            substitutions[name] = self._field_template % (self.FIELDS_FILE,
                                                          name)
        self._fields_used = substitute_placeholders(template, yaml_file,
                                                    substitutions)
        return mesh_file

    def level_instance(self, fine_level_params: List[float],
                       coarse_level_params: List[float]) -> LevelSimulation:
        fine_step = float(fine_level_params[0])
        coarse_step = float(coarse_level_params[0])

        common_dir = self._common_dir(fine_step)
        force_mkdir(common_dir, force=self._clean)
        mesh_file = self._build_level_files(fine_step, common_dir)
        n_points = len(self.extract_mesh(mesh_file)["points"])

        config = {
            "fine": {"step": fine_step, "common_files_dir": common_dir},
            "coarse": {"step": coarse_step,
                       "common_files_dir": (self._common_dir(coarse_step)
                                            if coarse_step else None)},
            "fields_params": self._fields_params,
            "fields_used_params": sorted(self._fields_used or
                                         self._fields.names),
            "flow123d": self._env["flow123d"],
        }
        return LevelSimulation(config_dict=config,
                               task_size=n_points / self.JOB_WEIGHT,
                               need_sample_workspace=True)

    # ------------------------------------------------------------------ #
    # mesh extraction
    # ------------------------------------------------------------------ #
    #: parsed meshes keyed by (path, mtime, keep_axes) — meshes are static
    #: per level, so per-sample calculate() calls must not re-parse them
    _MESH_CACHE = {}
    #: meshes parsed (cache misses) by the native parser and by GmshIO
    parsers = {"native": 0, "python": 0}

    @staticmethod
    def extract_mesh(mesh_file, keep_axes=None):
        """Bulk-element centers + region structure of a gmsh mesh.

        Boundary regions (physical names starting with '.') are excluded.
        Degenerate coordinate axes (planar meshes stored in 3-D) are
        dropped so the field dimension matches the true geometry; pass the
        fine mesh's ``keep_axes`` when extracting the coarse mesh so both
        agree on the dimension (a very coarse mesh can be degenerate along
        axes the fine one is not).

        :return: {'points': [n, dim], 'point_region_ids': [n],
                  'ele_ids': [n], 'region_map': {name: region_id},
                  'keep_axes': tuple of kept coordinate axes}
        """
        path = os.path.abspath(mesh_file)
        cache_key = (path, os.path.getmtime(path),
                     None if keep_axes is None else tuple(keep_axes))
        cached = FlowSim._MESH_CACHE.get(cache_key)
        if cached is not None:
            return cached

        from mlmc_tpu_torch import native

        parsed = native.parse_gmsh_mesh(path)
        FlowSim.parsers["native" if parsed is not None else "python"] += 1
        if parsed is not None:
            # C++ streaming parse (production meshes run to millions of
            # elements; the line-by-line Python reader costs minutes there)
            centers = parsed["centers"]
            regions = parsed["region_ids"]
            ele_ids = parsed["ele_ids"]
            region_map = parsed["region_map"]
        else:
            mesh = GmshIO(mesh_file)
            region_map, bc_regions = {}, set()
            for name, (region_id, _dim) in mesh.physical.items():
                clean_name = name.strip("\"'")
                region_map[clean_name] = region_id
                if clean_name.startswith("."):
                    bc_regions.add(region_id)

            node_xyz = {nid: np.asarray(xyz)
                        for nid, xyz in mesh.nodes.items()}
            ele_ids, regions, centers = [], [], []
            for ele_id, (_etype, tags, node_ids) in mesh.elements.items():
                region_id = tags[0]
                if region_id in bc_regions:
                    continue
                ele_ids.append(ele_id)
                regions.append(region_id)
                centers.append(
                    np.mean([node_xyz[n] for n in node_ids], axis=0))
            centers = np.asarray(centers, dtype=float)

        if keep_axes is None:
            # drop axes with zero RELATIVE extent: planar mesh in 3-D
            extent = centers.max(axis=0) - centers.min(axis=0)
            scale = max(float(extent.max()), 1e-300)
            keep = np.flatnonzero(extent > 1e-10 * scale)
            if len(keep) == 0:
                keep = np.arange(centers.shape[1])
            keep_axes = tuple(int(k) for k in keep)

        data = {
            "points": centers[:, list(keep_axes)],
            "point_region_ids": np.asarray(regions, dtype=int),
            "ele_ids": np.asarray(ele_ids, dtype=int),
            "region_map": region_map,
            "keep_axes": tuple(keep_axes),
        }
        FlowSim._MESH_CACHE[cache_key] = data
        return data

    # ------------------------------------------------------------------ #
    # per-sample calculation (runs inside the pool)
    # ------------------------------------------------------------------ #
    @staticmethod
    def _draw_fields(config, seed, fine_mesh, coarse_mesh, device=None):
        """One joint field realization over fine (+ coarse) centers, drawn
        on ``device`` (None: the current CUDA device).

        Drawing ONE field over the concatenated center sets gives the fine
        and coarse solves the same underlying randomness — the MLMC
        coupling that makes level differences small.

        :return: (fine {name: [n_f, 1]}, coarse {name: [n_c, 1]}), host
            arrays
        """
        device = resolve_device(device)
        # both the RFF mode structure and the draw derive from the sample
        # seed (its uint32 value): a renewed sample replays bit-identically
        key = int(seed) & 0xFFFFFFFF
        fields = create_corr_field(seed=key, device=device,
                                   **config["fields_params"])
        fields.set_outer_fields(config["fields_used_params"])

        points = fine_mesh["points"]
        region_ids = fine_mesh["point_region_ids"]
        region_map = fine_mesh["region_map"]
        n_fine = len(points)
        if coarse_mesh is not None:
            if coarse_mesh["region_map"] != region_map:
                raise ValueError("fine/coarse meshes disagree on regions")
            points = np.concatenate([points, coarse_mesh["points"]])
            region_ids = np.concatenate([region_ids,
                                         coarse_mesh["point_region_ids"]])
        fields.set_points(points, region_ids, region_map)

        # the draws come from a host generator, so a seed names the same
        # field on every device; the field is computed on ``device``
        draw = fields.sample(torch.Generator().manual_seed(key))
        fine = {k: v[:n_fine, None] for k, v in draw.items()}
        coarse = ({k: v[n_fine:, None] for k, v in draw.items()}
                  if coarse_mesh is not None else {})
        return fine, coarse

    @staticmethod
    def _run_solver(kind, config, mesh_data, field_values, seed):
        """Write the fields file + run flow123d in a private scratch dir."""
        import tempfile

        common_dir = config[kind]["common_files_dir"]
        scratch = tempfile.mkdtemp(prefix="flow_{}_{}_".format(kind, seed))
        try:
            from mlmc_tpu_torch import native

            fields_file = os.path.join(scratch, FlowSim.FIELDS_FILE)
            if not native.write_gmsh_fields(fields_file,
                                            mesh_data["ele_ids"],
                                            field_values):
                GmshIO().write_fields(fields_file, mesh_data["ele_ids"],
                                      field_values)
            argv = [config["flow123d"], "--yaml_balance",
                    "-i", scratch,
                    "-s", os.path.join(common_dir, FlowSim.YAML_FILE),
                    "-o", scratch]
            completed = subprocess.run(argv, capture_output=True, text=True,
                                       cwd=scratch)
            if completed.returncode != 0:
                raise RuntimeError(
                    "flow123d failed (rc={}), inputs/outputs kept at {}: "
                    "{}".format(completed.returncode, scratch,
                                completed.stderr[-1000:]))
            result = FlowSim._extract_result(scratch)
        except BaseException:
            # a failed run keeps its scratch dir (rendered inputs, fields
            # file, solver logs) for post-mortem — the error names the path
            raise
        else:
            shutil.rmtree(scratch, ignore_errors=True)
            return result

    @staticmethod
    def _extract_result(sample_dir, flux_regions=(".bc_outflow",)):
        """Total time-zero outflow flux from water_balance.yaml (negated so
        outflow is positive). Positive inflow at the outlet is a failure."""
        import yaml

        balance_file = os.path.join(sample_dir, "water_balance.yaml")
        with open(balance_file) as f:
            balance = yaml.safe_load(f)

        total = 0.0
        found = False
        for item in balance["data"]:
            if item["time"] > 0:
                break
            if item["region"] in flux_regions:
                flux, flux_in = float(item["data"][0]), float(item["data"][1])
                if flux_in > 1e-10:
                    raise RuntimeError("positive inflow at outlet region")
                total += flux
                found = True
        if not found:
            raise RuntimeError("no outflow region found in water balance")
        return np.array([-total])

    @staticmethod
    def calculate(config, seed, device=None):
        """One sample: the joint field drawn on ``device`` (None: the
        current CUDA device), then the solver runs for the fine and the
        coarse mesh: -> (fine, coarse) flat host arrays."""
        device = resolve_device(device)
        fine_mesh = FlowSim.extract_mesh(os.path.join(
            config["fine"]["common_files_dir"], FlowSim.MESH_FILE))
        coarse_mesh = None
        if config["coarse"]["step"]:
            # the fine mesh decides the kept axes so both meshes agree on
            # the point dimension (a very coarse mesh can be degenerate
            # along axes the fine one is not)
            coarse_mesh = FlowSim.extract_mesh(
                os.path.join(config["coarse"]["common_files_dir"],
                             FlowSim.MESH_FILE),
                keep_axes=fine_mesh["keep_axes"])

        fine_fields, coarse_fields = FlowSim._draw_fields(
            config, seed, fine_mesh, coarse_mesh, device)

        fine_res = FlowSim._run_solver("fine", config, fine_mesh,
                                       fine_fields, seed)
        coarse_res = (FlowSim._run_solver("coarse", config, coarse_mesh,
                                          coarse_fields, seed)
                      if coarse_mesh is not None
                      else np.zeros_like(fine_res))
        return fine_res.flatten(), coarse_res.flatten()

    # external binaries have no device batch path
    calculate_batch = None

    def n_ops_estimate(self, step):
        # solver cost ~ n_elements * log(n) ~ (1/h)^2 log(1/h)
        return (1.0 / step) ** 2 * np.log(max(1.0 / step, 2.0))

    def result_format(self) -> List[QuantitySpec]:
        return [QuantitySpec(name="conductivity", unit="m/s", shape=(1, 1),
                             times=[1], locations=["0"])]
