"""Reading BENCHMARK.json and the data files it names, and the rules every
name, unit and text in it keeps.

A cell (one entry of ``workloads``) is found by its name; its configuration
by the cell's ``config``; the cell's own parameters in
``<data dir>/workloads/<cell>.json``, where the data dir is the manifest's
first path. The code a cell runs is found by name as well: the job kind the
cell's file names in ``jobs/<kind>.py`` and each metric in
``metrics/<name>.py`` of the benchmark's code directory.
"""
import json
import os
import re

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")
SOURCES = ("device_trace", "program_span", "program_counter", "host_clock")


class Manifest:
    def __init__(self, root):
        self.root = os.path.abspath(root)
        with open(os.path.join(self.root, "BENCHMARK.json")) as f:
            self.data = json.load(f)
        self.data_dir = os.path.join(self.root, self.data["paths"][0])

    def cell(self, name):
        for w in self.data["workloads"]:
            if w["name"] == name:
                return w
        raise KeyError("no workload %r in BENCHMARK.json" % name)

    def config(self, name):
        for c in self.data["configs"]:
            if c["name"] == name:
                with open(os.path.join(self.root, c["file"])) as f:
                    return json.load(f)
        raise KeyError("no config %r in BENCHMARK.json" % name)

    def cell_file(self, name):
        with open(os.path.join(self.data_dir, "workloads", name + ".json")) as f:
            return json.load(f)

    def metrics(self, cell, traced):
        """The metric entries a run of ``cell`` reports: the end-to-end
        ones untraced, the per-layer ones traced; each where its
        ``workloads`` list names the cell, or everywhere without one."""
        group = self.data["per_layer"] if traced else self.data["end_to_end"]
        return [m for m in group if cell in m.get("workloads", [cell])]


def _text(value):
    return (isinstance(value, str) and 1 <= len(value) <= 200
            and "\n" not in value and "\t" not in value)


def problems(data):
    """What in a BENCHMARK.json breaks the rules of names, units, texts and
    references (an empty list when nothing does)."""
    out = []
    if not (1 <= len(data.get("paths", [])) <= 16
            and all(PATH.match(p) and ".." not in p.split("/") and not p.startswith("/")
                    for p in data["paths"])):
        out.append("paths")
    if not (1 <= len(data.get("command", [])) <= 32 and all(_text(w) for w in data["command"])):
        out.append("command")
    if not (isinstance(data.get("run_seconds"), int) and 1 <= data["run_seconds"] <= 51):
        out.append("run_seconds")
    configs = data.get("configs", [])
    for c in configs:
        if not NAME.match(c["name"]) or not _text(c["source"]) or not _text(c["why"]):
            out.append("config " + c["name"])
        if len(c["reduced"]) > 16 or not all(NAME.match(k) for k in c["reduced"]):
            out.append("reduced of " + c["name"])
    names = {c["name"] for c in configs}
    cells = data.get("workloads", [])
    for w in cells:
        if not (NAME.match(w["name"]) and NAME.match(w["traffic"]) and w["config"] in names
                and w["chips"] in (1, 4) and _text(w["why"])):
            out.append("workload " + w["name"])
    cell_names = {w["name"] for w in cells}
    metrics = data.get("end_to_end", []) + data.get("per_layer", [])
    for m in metrics:
        if not (NAME.match(m["name"]) and UNIT.match(m["unit"])
                and m["better"] in ("lower", "higher") and m["source"] in SOURCES
                and set(m.get("workloads", [])) <= cell_names):
            out.append("metric " + m["name"])
    for m in data.get("per_layer", []):
        if not _text(m["layer"]) or m["moves"] not in {e["name"] for e in data["end_to_end"]}:
            out.append("per-layer metric " + m["name"])
    for m in data.get("end_to_end", []):
        if m["source"] not in ("host_clock", "device_trace") or not 0 < m["bound"] <= 0.25:
            out.append("end-to-end metric " + m["name"])
    for group in (configs, cells, metrics):
        seen = [x["name"] for x in group]
        if len(seen) != len(set(seen)):
            out.append("duplicate names")
    return out
