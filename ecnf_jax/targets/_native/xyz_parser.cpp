// Fast GDB9/QM9 xyz parser.
//
// The QM9 preprocessing pipeline (ecnf_jax/targets/qm9.py) parses 133,885
// small xyz files; the pure-Python parser costs minutes of host time.  This
// C++ parser handles one xyz buffer per call (atom count, element charges,
// coordinates, the 17 scalar molecule properties) and is driven from Python
// via ctypes.  Semantics match the reference's process_xyz_gdb9
// (`qm9_download_data/data/prepare/process.py:180-243`), including the
// "*^" -> "e" exponent fix-up.
//
// Build: g++ -O2 -shared -fPIC -o libxyzparse.so xyz_parser.cpp
#include <cstdlib>
#include <cstring>
#include <cctype>

namespace {

// Element symbol -> nuclear charge (H, C, N, O, F only in GDB9).
int charge_of(const char* sym, int len) {
    if (len == 1) {
        switch (sym[0]) {
            case 'H': return 1;
            case 'C': return 6;
            case 'N': return 7;
            case 'O': return 8;
            case 'F': return 9;
        }
    }
    return -1;
}

// Parse a float token that may contain the GDB9 "*^" exponent quirk.
double parse_float_fixed(const char* start, const char* end) {
    char buf[64];
    int n = 0;
    for (const char* p = start; p < end && n < 63; ++p) {
        if (*p == '*') continue;        // "*^" -> "e"
        if (*p == '^') { buf[n++] = 'e'; continue; }
        buf[n++] = *p;
    }
    buf[n] = '\0';
    return std::strtod(buf, nullptr);
}

const char* skip_ws(const char* p, const char* end) {
    while (p < end && (*p == ' ' || *p == '\t' || *p == '\r')) ++p;
    return p;
}

const char* next_token(const char* p, const char* end, const char** tok_end) {
    p = skip_ws(p, end);
    const char* q = p;
    while (q < end && !std::isspace(static_cast<unsigned char>(*q))) ++q;
    *tok_end = q;
    return p;
}

const char* next_line(const char* p, const char* end) {
    while (p < end && *p != '\n') ++p;
    return (p < end) ? p + 1 : end;
}

}  // namespace

extern "C" {

// Parse one xyz buffer.
//
// Outputs:
//   num_atoms_out: int
//   charges_out:   int64[max_atoms]
//   positions_out: double[max_atoms * 3]
//   props_out:     double[15]  (A B C mu alpha homo lumo gap r2 zpve U0 U H G Cv)
//   index_out:     int (the GDB9 molecule index from the comment line)
// Returns 0 on success, negative on parse error.
int parse_xyz(
    const char* buf,
    long len,
    int max_atoms,
    int* num_atoms_out,
    long long* charges_out,
    double* positions_out,
    double* props_out,
    long long* index_out
) {
    const char* p = buf;
    const char* end = buf + len;

    // Line 1: atom count.
    const char* tok_end;
    const char* tok = next_token(p, end, &tok_end);
    if (tok == tok_end) return -1;
    int num_atoms = static_cast<int>(std::strtol(tok, nullptr, 10));
    if (num_atoms <= 0 || num_atoms > max_atoms) return -2;
    *num_atoms_out = num_atoms;
    p = next_line(p, end);

    // Line 2: "gdb <index> A B C mu alpha homo lumo gap r2 zpve U0 U H G Cv".
    const char* line_end = p;
    while (line_end < end && *line_end != '\n') ++line_end;
    {
        const char* q = p;
        // tag ("gdb")
        q = next_token(q, line_end, &tok_end); q = tok_end;
        // index
        q = next_token(q, line_end, &tok_end);
        if (q == tok_end) return -3;
        *index_out = std::strtoll(q, nullptr, 10);
        q = tok_end;
        for (int i = 0; i < 15; ++i) {
            q = next_token(q, line_end, &tok_end);
            if (q == tok_end) return -4;
            props_out[i] = parse_float_fixed(q, tok_end);
            q = tok_end;
        }
    }
    p = next_line(p, end);

    // Atom lines: "<El> x y z charge".
    for (int a = 0; a < num_atoms; ++a) {
        line_end = p;
        while (line_end < end && *line_end != '\n') ++line_end;
        const char* q = p;
        q = next_token(q, line_end, &tok_end);
        if (q == tok_end) return -5;
        int z = charge_of(q, static_cast<int>(tok_end - q));
        if (z < 0) return -6;
        charges_out[a] = z;
        q = tok_end;
        for (int d = 0; d < 3; ++d) {
            q = next_token(q, line_end, &tok_end);
            if (q == tok_end) return -7;
            positions_out[a * 3 + d] = parse_float_fixed(q, tok_end);
            q = tok_end;
        }
        p = next_line(p, end);
    }
    return 0;
}

}  // extern "C"
