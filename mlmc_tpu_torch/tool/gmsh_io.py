"""Gmsh MSH v1/v2 (ASCII) reader, v2 writer (counterpart of
``mlmc_tpu/tool/gmsh_io.py``; host numpy).

Re-design of reference mlmc/tool/gmsh_io.py:21-343 (v1 $NOD/$ELM sections
handled like reference :91-133) with the same public surface: ``GmshIO`` holding ``nodes`` {id: (x, y, z)}, ``elements``
{id: (type, tags, node_ids)}, ``physical`` {name: (id, dim)}, and
``element_data`` read from ``$ElementData`` blocks; ``read``,
``write_ascii``, ``write_element_data`` / ``write_fields``,
``read_element_data``. Host-side I/O utility for mesh-based simulations
(the device pipelines never touch it).
"""
import numpy as np


class GmshIO:
    """Store and (de)serialize Gmsh v2 ASCII mesh data."""

    def __init__(self, filename=None):
        self.reset()
        self.filename = filename
        if filename is not None:
            with open(filename) as f:
                self.read(f)

    def reset(self):
        self.nodes = {}
        self.elements = {}
        self.physical = {}
        self.element_data = {}
        self.normals = {}

    # ------------------------------------------------------------------ #
    def read(self, mshfile=None):
        """Parse $MeshFormat/$PhysicalNames/$Nodes/$Elements/$ElementData."""
        if mshfile is None:
            mshfile = open(self.filename)
        self.reset()

        mode = None
        lines = iter(mshfile)
        for raw in lines:
            line = raw.strip()
            if not line:
                continue
            if line.startswith("$"):
                section = line[1:]
                if section.lower().startswith("end"):  # $End... / v1 $END...
                    mode = None
                else:
                    mode = section
                    if mode == "MeshFormat":
                        next(lines)  # version line
                        mode = None
                    elif mode == "PhysicalNames":
                        n = int(next(lines))
                        for _ in range(n):
                            parts = next(lines).split()
                            dim, phys_id = int(parts[0]), int(parts[1])
                            name = " ".join(parts[2:]).strip('"')
                            self.physical[name] = (phys_id, dim)
                        mode = None
                    elif mode == "Nodes":
                        n = int(next(lines))
                        for _ in range(n):
                            parts = next(lines).split()
                            self.nodes[int(parts[0])] = tuple(
                                float(x) for x in parts[1:4])
                        mode = None
                    elif mode == "Elements":
                        n = int(next(lines))
                        for _ in range(n):
                            parts = [int(x) for x in next(lines).split()]
                            elm_id, elm_type, n_tags = parts[0], parts[1], parts[2]
                            tags = parts[3:3 + n_tags]
                            node_ids = parts[3 + n_tags:]
                            self.elements[elm_id] = (elm_type, tags, node_ids)
                        mode = None
                    elif mode == "ElementData":
                        self._read_element_data_block(lines)
                        mode = None
                    elif mode == "NOD":
                        # Gmsh v1: $NOD n / 'id x y z' (reference :120-133)
                        n = int(next(lines))
                        for _ in range(n):
                            parts = next(lines).split()
                            self.nodes[int(parts[0])] = tuple(
                                float(x) for x in parts[1:4])
                        mode = None
                    elif mode == "ELM":
                        # Gmsh v1: 'id type reg-phys reg-elem n-nodes nodes…'
                        n = int(next(lines))
                        for _ in range(n):
                            parts = [int(x) for x in next(lines).split()]
                            elm_id, elm_type = parts[0], parts[1]
                            tags = parts[2:4]
                            node_ids = parts[5:]
                            self.elements[elm_id] = (elm_type, tags, node_ids)
                        mode = None
        return self

    def _read_element_data_block(self, lines):
        n_str = int(next(lines))
        strings = [next(lines).strip().strip('"') for _ in range(n_str)]
        name = strings[0] if strings else ""
        n_real = int(next(lines))
        reals = [float(next(lines)) for _ in range(n_real)]
        time = reals[0] if reals else 0.0
        n_int = int(next(lines))
        ints = [int(next(lines)) for _ in range(n_int)]
        n_entries = ints[2] if len(ints) >= 3 else 0
        values = {}
        for _ in range(n_entries):
            parts = next(lines).split()
            values[int(parts[0])] = [float(v) for v in parts[1:]]
        self.element_data.setdefault(name, {})[time] = values

    def read_element_data(self):
        """:return: {field_name: {time: {ele_id: [values]}}}"""
        return self.element_data

    def read_element_data_head(self, mshfile):
        """Parse one $ElementData header from an open file positioned after
        the section tag (reference gmsh_io.py:48-71).

        :return: (name, time, time_idx, n_components, n_entries)
        """
        lines = iter(mshfile)
        n_str = int(next(lines))
        strings = [next(lines).strip().strip('"') for _ in range(n_str)]
        n_real = int(next(lines))
        reals = [float(next(lines)) for _ in range(n_real)]
        n_int = int(next(lines))
        ints = [int(next(lines)) for _ in range(n_int)]
        name = strings[0] if strings else ""
        time = reals[0] if reals else 0.0
        time_idx = ints[0] if ints else 0
        n_comp = ints[1] if len(ints) > 1 else 1
        n_entries = ints[2] if len(ints) > 2 else 0
        return name, time, time_idx, n_comp, n_entries

    # ------------------------------------------------------------------ #
    def write_ascii(self, mshfile=None):
        """Write $MeshFormat/$PhysicalNames/$Nodes/$Elements."""
        close = False
        if mshfile is None:
            mshfile = open(self.filename, "w")
            close = True
        elif isinstance(mshfile, str):
            mshfile = open(mshfile, "w")
            close = True

        mshfile.write("$MeshFormat\n2.2 0 8\n$EndMeshFormat\n")
        if self.physical:
            mshfile.write("$PhysicalNames\n{}\n".format(len(self.physical)))
            for name, (phys_id, dim) in self.physical.items():
                mshfile.write('{} {} "{}"\n'.format(dim, phys_id, name))
            mshfile.write("$EndPhysicalNames\n")
        mshfile.write("$Nodes\n{}\n".format(len(self.nodes)))
        for node_id, xyz in self.nodes.items():
            mshfile.write("{} {} {} {}\n".format(node_id, *xyz))
        mshfile.write("$EndNodes\n")
        mshfile.write("$Elements\n{}\n".format(len(self.elements)))
        for elm_id, (elm_type, tags, node_ids) in self.elements.items():
            mshfile.write(" ".join(
                str(v) for v in
                [elm_id, elm_type, len(tags), *tags, *node_ids]) + "\n")
        mshfile.write("$EndElements\n")
        if close:
            mshfile.close()

    def write_binary(self, filename=None):
        """Write Gmsh v2.2 BINARY msh (nodes + elements), little-endian
        (reference gmsh_io.py:219-248)."""
        import struct

        if filename is None:
            filename = self.filename
        with open(filename, "wb") as f:
            f.write(b"$MeshFormat\n2.2 1 8\n")
            f.write(struct.pack("<i", 1))
            f.write(b"\n$EndMeshFormat\n")
            f.write(b"$Nodes\n")
            f.write(str(len(self.nodes)).encode() + b"\n")
            for node_id, xyz in self.nodes.items():
                f.write(struct.pack("<i3d", node_id, *xyz))
            f.write(b"\n$EndNodes\n")
            f.write(b"$Elements\n")
            f.write(str(len(self.elements)).encode() + b"\n")
            # group elements by (type, n_tags) headers
            from collections import defaultdict
            groups = defaultdict(list)
            for elm_id, (etype, tags, node_ids) in self.elements.items():
                groups[(etype, len(tags))].append((elm_id, tags, node_ids))
            for (etype, n_tags), elems in groups.items():
                f.write(struct.pack("<3i", etype, len(elems), n_tags))
                for elm_id, tags, node_ids in elems:
                    f.write(struct.pack(
                        "<{}i".format(1 + n_tags + len(node_ids)),
                        elm_id, *tags, *node_ids))
            f.write(b"\n$EndElements\n")

    def write_element_data(self, f, ele_ids, name, values):
        """Append one $ElementData block (reference gmsh_io.py:250-287).

        :param f: open file object
        :param ele_ids: iterable of element ids
        :param name: field name
        :param values: array [n_elements, n_components]
        """
        if hasattr(values, "detach"):  # a tensor on any device
            values = values.detach().cpu().numpy()
        values = np.atleast_2d(np.asarray(values, dtype=float))
        if values.shape[0] == 1 and len(list(ele_ids)) != 1:
            values = values.T
        n_els = values.shape[0]
        n_comp = values.shape[1]
        f.write("$ElementData\n")
        f.write('1\n"{}"\n'.format(name))
        f.write("1\n0.0\n")
        f.write("3\n0\n{}\n{}\n".format(n_comp, n_els))
        for ele_id, vals in zip(ele_ids, values):
            f.write("{} {}\n".format(
                ele_id, " ".join(repr(float(v)) for v in vals)))
        f.write("$EndElementData\n")

    def write_fields(self, msh_file, ele_ids, fields):
        """Write mesh + per-element fields (used by FlowSim-style sims,
        reference flow_mc.py:313)."""
        with open(msh_file, "w") as f:
            self.filename_backup, self.filename = getattr(self, "filename", None), None
            mshfile_obj = f
            f.write("$MeshFormat\n2.2 0 8\n$EndMeshFormat\n")
            f.write("$Nodes\n{}\n".format(len(self.nodes)))
            for node_id, xyz in self.nodes.items():
                f.write("{} {} {} {}\n".format(node_id, *xyz))
            f.write("$EndNodes\n")
            f.write("$Elements\n{}\n".format(len(self.elements)))
            for elm_id, (elm_type, tags, node_ids) in self.elements.items():
                f.write(" ".join(
                    str(v) for v in
                    [elm_id, elm_type, len(tags), *tags, *node_ids]) + "\n")
            f.write("$EndElements\n")
            for name, values in fields.items():
                self.write_element_data(f, ele_ids, name, values)
