// Native WordPiece tokenizer fast path (C++, exposed via ctypes).
//
// The framework's host-side input pipeline tokenizes every caption/question
// per epoch (masking is re-randomized each epoch, so results cannot be
// cached); this implements the ASCII fast path of HF BasicTokenizer +
// WordPiece semantics (lowercase, punctuation split, greedy longest-match
// with "##" continuations, 100-char word cap, [UNK] fallback). Non-ASCII
// inputs fall back to the pure-Python tokenizer
// (mmvqa_tpu_torch.data.tokenizer), which is the reference for parity tests.
//
// Built with the host's C++ compiler by mmvqa_tpu_torch/native/loader.py.

#include <cctype>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <string>
#include <unordered_map>
#include <vector>

namespace {

struct Vocab {
    std::unordered_map<std::string, int32_t> tok2id;
    int32_t unk_id = -1;
};

inline bool is_ascii_punct(unsigned char c) {
    return (c >= 33 && c <= 47) || (c >= 58 && c <= 64) ||
           (c >= 91 && c <= 96) || (c >= 123 && c <= 126);
}

inline bool is_space(unsigned char c) {
    return c == ' ' || c == '\t' || c == '\n' || c == '\r';
}

inline bool is_control(unsigned char c) {
    return c < 32 && !is_space(c);
}

// Greedy longest-match wordpiece over one lowercase word.
void wordpiece(const Vocab& v, const std::string& word,
               std::vector<int32_t>& out) {
    if (word.size() > 100) {
        out.push_back(v.unk_id);
        return;
    }
    size_t start = 0;
    std::vector<int32_t> pieces;
    while (start < word.size()) {
        size_t end = word.size();
        int32_t cur = -1;
        while (start < end) {
            std::string sub =
                (start > 0 ? "##" : "") + word.substr(start, end - start);
            auto it = v.tok2id.find(sub);
            if (it != v.tok2id.end()) {
                cur = it->second;
                break;
            }
            --end;
        }
        if (cur < 0) {
            out.push_back(v.unk_id);
            return;
        }
        pieces.push_back(cur);
        start = end;
    }
    out.insert(out.end(), pieces.begin(), pieces.end());
}

}  // namespace

extern "C" {

void* wp_load(const char* vocab_path) {
    FILE* f = fopen(vocab_path, "rb");
    if (!f) return nullptr;
    auto* v = new Vocab();
    char line[4096];
    int32_t idx = 0;
    while (fgets(line, sizeof(line), f)) {
        size_t n = strlen(line);
        while (n && (line[n - 1] == '\n' || line[n - 1] == '\r')) --n;
        if (n) v->tok2id.emplace(std::string(line, n), idx);
        ++idx;
    }
    fclose(f);
    auto it = v->tok2id.find("[UNK]");
    if (it == v->tok2id.end()) {
        delete v;
        return nullptr;
    }
    v->unk_id = it->second;
    return v;
}

void wp_free(void* handle) { delete static_cast<Vocab*>(handle); }

// Tokenize ASCII text to wordpiece ids. Returns the number of ids written,
// or -1 if the text contains non-ASCII bytes (caller must fall back).
int32_t wp_tokenize(void* handle, const char* text, int32_t* out,
                    int32_t max_out) {
    const Vocab& v = *static_cast<Vocab*>(handle);
    int32_t n_out = 0;
    std::string word;
    std::vector<int32_t> ids;
    auto flush_word = [&]() {
        if (!word.empty()) {
            wordpiece(v, word, ids);
            word.clear();
        }
    };
    for (const unsigned char* p = (const unsigned char*)text; *p; ++p) {
        unsigned char c = *p;
        if (c >= 128) return -1;  // non-ASCII: python fallback
        if (c == 0xFFFD || is_control(c)) continue;
        if (is_space(c)) {
            flush_word();
        } else if (is_ascii_punct(c)) {
            flush_word();
            word.push_back((char)c);
            flush_word();
        } else {
            word.push_back((char)tolower(c));
        }
    }
    flush_word();
    if ((int32_t)ids.size() > max_out) return -2;
    for (int32_t id : ids) out[n_out++] = id;
    return n_out;
}

}  // extern "C"
