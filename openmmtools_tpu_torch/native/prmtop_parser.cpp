// Fast Amber prmtop section parser.
//
// The host side of the loader (models/amber.py parse_prmtop): the
// reference delegates topology parsing to openmm.app.AmberPrmtopFile
// (C++-backed); here a small C++ library parses the %FLAG/%FORMAT
// sectioned fixed-width format directly into flat arrays, exposed through
// a C ABI that models/amber.py loads with ctypes. It is built at first use
// by the host C++ compiler (ops/_build.py: g++ -O2 -shared -fPIC). The
// pure-Python parser (parse_prmtop_python) stays as the oracle.
//
// Sections are listed in the order of the file. A numeric token that does
// not parse, or a last line without its newline (a file cut short), sets
// the handle's status, which the caller reads (prmtop_status) and raises
// on.
//
// Format reference: Amber file formats specification (public), e.g.
//   %FLAG POINTERS
//   %FORMAT(10I8)
//   <fixed-width records...>
#include <cctype>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <string>
#include <unordered_map>
#include <vector>

namespace {

struct Section {
    int kind = -1;          // 0 = int, 1 = double, 2 = string
    int width = 0;          // field width for strings
    std::vector<long long> ints;
    std::vector<double> doubles;
    std::string strings;    // concatenated fixed-width fields
    long long n_strings = 0;
};

struct Prmtop {
    std::unordered_map<std::string, Section> sections;
    std::vector<std::string> order;   // the flags in the order of the file
    int status = 0;   // 0 ok, 1 a numeric token did not parse, 2 cut short
};

// parse "%FORMAT(20a4)" / "(10I8)" / "(5E16.8)" -> (kind, width)
bool parse_format(const char* fmt, int* kind, int* width) {
    const char* p = strchr(fmt, '(');
    if (!p) return false;
    ++p;
    while (*p && isdigit(*p)) ++p;  // repeat count
    char c = tolower(*p);
    ++p;
    int w = atoi(p);
    if (c == 'i') { *kind = 0; }
    else if (c == 'e' || c == 'f' || c == 'g') { *kind = 1; }
    else if (c == 'a') { *kind = 2; }
    else return false;
    *width = w > 0 ? w : 80;
    return true;
}

// returns false where a numeric token does not parse
bool parse_data_line(Section& sec, const char* line, size_t len) {
    // strip trailing newline/CR
    while (len && (line[len - 1] == '\n' || line[len - 1] == '\r')) --len;
    if (sec.kind == 2) {
        for (size_t off = 0; off < len; off += sec.width) {
            size_t n = len - off < (size_t)sec.width ? len - off
                                                     : (size_t)sec.width;
            std::string field(line + off, n);
            field.resize(sec.width, ' ');
            sec.strings += field;
            ++sec.n_strings;
        }
        return true;
    }
    // numeric: whitespace-separated tokens (fixed width but strtod skips
    // leading spaces, and Amber always space-separates numeric fields)
    const char* p = line;
    const char* end = line + len;
    char* next = nullptr;
    while (p < end) {
        while (p < end && isspace(*p)) ++p;
        if (p >= end) break;
        if (sec.kind == 0) {
            long long v = strtoll(p, &next, 10);
            if (next == p) return false;
            sec.ints.push_back(v);
        } else {
            double v = strtod(p, &next);
            if (next == p) return false;
            sec.doubles.push_back(v);
        }
        p = next;
    }
    return true;
}

}  // namespace

extern "C" {

void* prmtop_open(const char* path) {
    FILE* f = fopen(path, "rb");
    if (!f) return nullptr;
    auto* top = new Prmtop();
    char* line = nullptr;
    size_t cap = 0;
    ssize_t n;
    Section* current = nullptr;
    std::string flag;
    while ((n = getline(&line, &cap, f)) >= 0) {
        if (n == 0 || line[n - 1] != '\n') top->status = 2;
        if (line[0] == '%') {
            if (!strncmp(line, "%FLAG", 5)) {
                const char* p = line + 5;
                while (*p && isspace(*p)) ++p;
                const char* q = p;
                while (*q && !isspace(*q)) ++q;
                flag.assign(p, q - p);
                if (!top->sections.count(flag)) top->order.push_back(flag);
                current = &top->sections[flag];
            } else if (!strncmp(line, "%FORMAT", 7) && current) {
                parse_format(line, &current->kind, &current->width);
            }
            // %VERSION / %COMMENT ignored
            continue;
        }
        if (current && current->kind >= 0 &&
            !parse_data_line(*current, line, (size_t)n) && !top->status)
            top->status = 1;
    }
    free(line);
    fclose(f);
    return top;
}

void prmtop_close(void* h) { delete static_cast<Prmtop*>(h); }

// kind: 0 int, 1 double, 2 string; -1 = missing
int prmtop_section_kind(void* h, const char* flag) {
    auto& secs = static_cast<Prmtop*>(h)->sections;
    auto it = secs.find(flag);
    return it == secs.end() ? -1 : it->second.kind;
}

long long prmtop_section_len(void* h, const char* flag) {
    auto& secs = static_cast<Prmtop*>(h)->sections;
    auto it = secs.find(flag);
    if (it == secs.end()) return 0;
    const Section& s = it->second;
    if (s.kind == 0) return (long long)s.ints.size();
    if (s.kind == 1) return (long long)s.doubles.size();
    return s.n_strings;
}

int prmtop_string_width(void* h, const char* flag) {
    auto& secs = static_cast<Prmtop*>(h)->sections;
    auto it = secs.find(flag);
    return it == secs.end() ? 0 : it->second.width;
}

long long prmtop_n_sections(void* h) {
    return (long long)static_cast<Prmtop*>(h)->order.size();
}

// 0 ok, 1 a numeric token did not parse, 2 the file was cut short
int prmtop_status(void* h) { return static_cast<Prmtop*>(h)->status; }

// the name of section idx, in the order of the file, into buf (<=127 chars)
void prmtop_section_name(void* h, long long idx, char* buf) {
    auto& order = static_cast<Prmtop*>(h)->order;
    if (idx < 0 || idx >= (long long)order.size()) {
        buf[0] = 0;
        return;
    }
    strncpy(buf, order[idx].c_str(), 127);
    buf[127] = 0;
}

void prmtop_copy_longs(void* h, const char* flag, long long* out) {
    auto& s = static_cast<Prmtop*>(h)->sections[flag];
    memcpy(out, s.ints.data(), s.ints.size() * sizeof(long long));
}

void prmtop_copy_doubles(void* h, const char* flag, double* out) {
    auto& s = static_cast<Prmtop*>(h)->sections[flag];
    memcpy(out, s.doubles.data(), s.doubles.size() * sizeof(double));
}

void prmtop_copy_strings(void* h, const char* flag, char* out) {
    auto& s = static_cast<Prmtop*>(h)->sections[flag];
    memcpy(out, s.strings.data(), s.strings.size());
}

}  // extern "C"
