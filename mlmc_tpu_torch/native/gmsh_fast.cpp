// Native gmsh v2 ASCII mesh parser + $ElementData writer.
//
// FlowSim-scale meshes run to millions of elements (the reference budgets
// task sizes against 17e6 mesh points, mlmc/tool/flow_mc.py:213-217); the
// Python line-by-line parse costs minutes there. This parser streams the
// file once with manual number scanning (no iostream locale machinery) and
// computes bulk-element centers in place; the writer emits the per-element
// field blocks FlowSim feeds to flow123d without per-line Python string
// formatting.
//
// Exposed C ABI (ctypes bindings in mlmc_tpu_torch/native/__init__.py):
//   gmsh_mesh_open(path)        -> handle (nullptr on parse failure)
//   gmsh_mesh_n_elements(h)     -> number of BULK elements
//   gmsh_mesh_ele_ids(h, out)      int64[n]
//   gmsh_mesh_region_ids(h, out)   int32[n]
//   gmsh_mesh_centers(h, out)      double[n, 3]
//   gmsh_mesh_regions(h, buf, cap) "name\tid\n"-joined physical names
//   gmsh_mesh_close(h)
//
//   gmsh_fields_open(path)      -> handle (writes the msh2 header)
//   gmsh_fields_add(h, name, ele_ids int64*, values double*, n, n_comp)
//   gmsh_fields_close(h)        -> 0 on success
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <string>
#include <unordered_map>
#include <vector>

namespace {

struct Mesh {
    std::vector<int64_t> ele_ids;
    std::vector<int32_t> region_ids;
    std::vector<double> centers;  // [n, 3]
    std::string regions;          // "name\tid\n"...
};

// ---------------------------------------------------------------- utils
struct Scanner {
    const char* p;
    const char* end;
    bool ok = true;

    explicit Scanner(const std::string& data)
        : p(data.data()), end(data.data() + data.size()) {}

    void skip_ws() {
        while (p < end && (*p == ' ' || *p == '\t' || *p == '\n' ||
                           *p == '\r'))
            ++p;
    }

    long long next_int() {
        skip_ws();
        char* q = nullptr;
        long long v = strtoll(p, &q, 10);
        if (q == p) ok = false;
        p = q;
        return v;
    }

    double next_double() {
        skip_ws();
        char* q = nullptr;
        double v = strtod(p, &q);
        if (q == p) ok = false;
        p = q;
        return v;
    }

    void next_line() {
        while (p < end && *p != '\n') ++p;
        if (p < end) ++p;
    }

    // current line's content (trimmed), advancing past it
    std::string take_line() {
        skip_ws();
        const char* s = p;
        while (p < end && *p != '\n' && *p != '\r') ++p;
        std::string line(s, p - s);
        next_line();
        return line;
    }
};

bool read_file(const char* path, std::string* out) {
    FILE* f = fopen(path, "rb");
    if (!f) return false;
    fseek(f, 0, SEEK_END);
    long size = ftell(f);
    fseek(f, 0, SEEK_SET);
    out->resize(size > 0 ? static_cast<size_t>(size) : 0);
    size_t got = size > 0 ? fread(&(*out)[0], 1, out->size(), f) : 0;
    fclose(f);
    return got == out->size();
}

void* gmsh_mesh_open_impl(const char* path);

}  // namespace

extern "C" {

void* gmsh_mesh_open(const char* path) {
    // a corrupted section count (e.g. claiming 1e18 nodes) throws
    // length_error/bad_alloc from reserve; an exception escaping the C
    // ABI would terminate the embedding Python process
    try {
        return gmsh_mesh_open_impl(path);
    } catch (...) {
        return nullptr;
    }
}

}  // extern "C"

namespace {

void* gmsh_mesh_open_impl(const char* path) {
    std::string data;
    if (!read_file(path, &data)) return nullptr;

    Scanner sc(data);
    std::unordered_map<int64_t, size_t> node_index;
    std::vector<double> node_xyz;  // [n_nodes, 3]
    std::unordered_map<int32_t, bool> is_bc;  // region id -> boundary?
    std::string regions;
    bool saw_nodes = false, saw_elements = false;

    std::vector<int64_t> ele_ids;
    std::vector<int32_t> region_ids;
    std::vector<double> centers;

    while (sc.p < sc.end) {
        sc.skip_ws();
        if (sc.p >= sc.end) break;
        if (*sc.p != '$') {  // stray content outside a known section
            sc.next_line();
            continue;
        }
        std::string tag = sc.take_line();
        if (tag == "$PhysicalNames") {
            long long n = sc.next_int();
            for (long long i = 0; i < n && sc.ok; ++i) {
                sc.next_int();  // dim
                long long id = sc.next_int();
                std::string rest = sc.take_line();
                // strip quotes and whitespace
                size_t b = rest.find_first_not_of(" \t\"'");
                size_t e = rest.find_last_not_of(" \t\"'");
                std::string name = (b == std::string::npos)
                                       ? std::string()
                                       : rest.substr(b, e - b + 1);
                is_bc[static_cast<int32_t>(id)] =
                    !name.empty() && name[0] == '.';
                regions += name;
                regions += '\t';
                regions += std::to_string(id);
                regions += '\n';
            }
        } else if (tag == "$Nodes") {
            long long n = sc.next_int();
            node_xyz.reserve(static_cast<size_t>(n) * 3);
            for (long long i = 0; i < n && sc.ok; ++i) {
                int64_t id = sc.next_int();
                node_index.emplace(id, node_xyz.size() / 3);
                node_xyz.push_back(sc.next_double());
                node_xyz.push_back(sc.next_double());
                node_xyz.push_back(sc.next_double());
            }
            saw_nodes = sc.ok;
        } else if (tag == "$Elements") {
            long long n = sc.next_int();
            ele_ids.reserve(n);
            for (long long i = 0; i < n && sc.ok; ++i) {
                int64_t id = sc.next_int();
                sc.next_int();  // element type (node count from the line)
                long long n_tags = sc.next_int();
                int32_t region = 0;
                for (long long t = 0; t < n_tags; ++t) {
                    long long v = sc.next_int();
                    if (t == 0) region = static_cast<int32_t>(v);
                }
                // remaining integers on this line are node ids
                double cx = 0, cy = 0, cz = 0;
                int n_nodes = 0;
                for (;;) {
                    const char* save = sc.p;
                    // peek: stop at end of line
                    while (sc.p < sc.end && (*sc.p == ' ' || *sc.p == '\t'))
                        ++sc.p;
                    if (sc.p >= sc.end || *sc.p == '\n' || *sc.p == '\r')
                        break;
                    char* q = nullptr;
                    long long nid = strtoll(sc.p, &q, 10);
                    if (q == sc.p) { sc.p = save; break; }
                    sc.p = q;
                    auto it = node_index.find(nid);
                    if (it == node_index.end()) { sc.ok = false; break; }
                    const double* xyz = &node_xyz[it->second * 3];
                    cx += xyz[0]; cy += xyz[1]; cz += xyz[2];
                    ++n_nodes;
                }
                sc.next_line();
                if (n_nodes == 0) { sc.ok = false; break; }
                // keep EVERY element here; boundary regions are filtered
                // after the full scan ($PhysicalNames may follow $Elements)
                ele_ids.push_back(id);
                region_ids.push_back(region);
                centers.push_back(cx / n_nodes);
                centers.push_back(cy / n_nodes);
                centers.push_back(cz / n_nodes);
            }
            saw_elements = sc.ok;
        } else {
            // skip unknown section up to its $End tag
            std::string end_tag = "$End" + tag.substr(1);
            while (sc.p < sc.end) {
                std::string line = sc.take_line();
                if (line == end_tag) break;
            }
            continue;
        }
        // consume the section's $End line
        sc.skip_ws();
        if (sc.p < sc.end && *sc.p == '$') sc.take_line();
    }

    if (!sc.ok || !saw_nodes || !saw_elements) return nullptr;
    // drop boundary-region elements now that every section is parsed
    // (section order in msh2 files is not fixed)
    Mesh* mesh = new Mesh();
    size_t kept = 0;
    for (size_t i = 0; i < ele_ids.size(); ++i) {
        auto bc = is_bc.find(region_ids[i]);
        if (bc != is_bc.end() && bc->second) continue;
        ele_ids[kept] = ele_ids[i];
        region_ids[kept] = region_ids[i];
        centers[kept * 3] = centers[i * 3];
        centers[kept * 3 + 1] = centers[i * 3 + 1];
        centers[kept * 3 + 2] = centers[i * 3 + 2];
        ++kept;
    }
    ele_ids.resize(kept);
    region_ids.resize(kept);
    centers.resize(kept * 3);
    mesh->ele_ids = std::move(ele_ids);
    mesh->region_ids = std::move(region_ids);
    mesh->centers = std::move(centers);
    mesh->regions = std::move(regions);
    return mesh;
}

}  // namespace

extern "C" {

uint64_t gmsh_mesh_n_elements(void* h) {
    return static_cast<Mesh*>(h)->ele_ids.size();
}

void gmsh_mesh_ele_ids(void* h, int64_t* out) {
    Mesh* m = static_cast<Mesh*>(h);
    memcpy(out, m->ele_ids.data(), m->ele_ids.size() * sizeof(int64_t));
}

void gmsh_mesh_region_ids(void* h, int32_t* out) {
    Mesh* m = static_cast<Mesh*>(h);
    memcpy(out, m->region_ids.data(), m->region_ids.size() * sizeof(int32_t));
}

void gmsh_mesh_centers(void* h, double* out) {
    Mesh* m = static_cast<Mesh*>(h);
    memcpy(out, m->centers.data(), m->centers.size() * sizeof(double));
}

int64_t gmsh_mesh_regions(void* h, char* buf, uint64_t cap) {
    Mesh* m = static_cast<Mesh*>(h);
    if (m->regions.size() + 1 > cap)
        return -static_cast<int64_t>(m->regions.size() + 1);
    memcpy(buf, m->regions.data(), m->regions.size());
    buf[m->regions.size()] = '\0';
    return static_cast<int64_t>(m->regions.size());
}

void gmsh_mesh_close(void* h) { delete static_cast<Mesh*>(h); }

// ------------------------------------------------------------- writer
void* gmsh_fields_open(const char* path) {
    FILE* f = fopen(path, "wb");
    if (!f) return nullptr;
    // fields files carry only $ElementData blocks (the mesh itself lives
    // in the level's common mesh file) — same shape the Python writer
    // produces from an empty GmshIO
    fputs("$MeshFormat\n2.2 0 8\n$EndMeshFormat\n", f);
    fputs("$Nodes\n0\n$EndNodes\n$Elements\n0\n$EndElements\n", f);
    return f;
}

int gmsh_fields_add(void* h, const char* name, const int64_t* ele_ids,
                    const double* values, uint64_t n, uint32_t n_comp) {
    FILE* f = static_cast<FILE*>(h);
    fprintf(f, "$ElementData\n1\n\"%s\"\n1\n0.0\n3\n0\n%u\n%llu\n", name,
            n_comp, static_cast<unsigned long long>(n));
    std::string line;
    line.reserve(32 * (n_comp + 1));
    char num[32];
    for (uint64_t i = 0; i < n; ++i) {
        line.clear();
        snprintf(num, sizeof(num), "%lld",
                 static_cast<long long>(ele_ids[i]));
        line += num;
        for (uint32_t c = 0; c < n_comp; ++c) {
            snprintf(num, sizeof(num), " %.17g", values[i * n_comp + c]);
            line += num;
        }
        line += '\n';
        if (fwrite(line.data(), 1, line.size(), f) != line.size()) return -1;
    }
    fputs("$EndElementData\n", f);
    return 0;
}

int gmsh_fields_close(void* h) {
    return fclose(static_cast<FILE*>(h)) == 0 ? 0 : -1;
}

}  // extern "C"
