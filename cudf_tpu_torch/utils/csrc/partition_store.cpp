// Host-memory partition store with LRU disk spill (the port's copy of
// native/partition_store.cpp, which it does not build or load).
//
// The analog of rapidsmpf's BufferResource (reservation-based admission and
// spill under memory pressure; reference: cpp/libcudf_streaming/include/
// cudf_streaming/table_chunk.hpp:19 memory_reserve_or_wait) combined with
// cuDF's SpillManager device->host spilling (python/cudf/cudf/core/buffer/
// spill_manager.py:202). Here the tiers are host RAM -> disk: the device
// holds the active partitions (torch tensors, under utils/hbm.py's budget),
// spilled partitions live in this store, and when its RAM budget is
// exceeded the least recently used buffers spill to files.
//
// Exposed as a C ABI for ctypes (utils/native.py builds it with g++ on
// first use).

#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <list>
#include <mutex>
#include <string>
#include <unordered_map>
#include <vector>

namespace {

struct Buffer {
    std::vector<uint8_t> data;   // empty when spilled
    std::string path;            // spill file (when spilled)
    size_t nbytes = 0;
    bool spilled = false;
    std::list<uint64_t>::iterator lru_it;
};

struct Store {
    std::mutex mu;
    std::unordered_map<uint64_t, Buffer> bufs;
    std::list<uint64_t> lru;  // front = most recent
    size_t budget = 0;
    size_t resident = 0;
    std::string spill_dir;
    uint64_t spill_count = 0;
    uint64_t unspill_count = 0;
    uint64_t next_file = 0;
};

bool write_file(const std::string& path, const uint8_t* p, size_t n) {
    FILE* f = std::fopen(path.c_str(), "wb");
    if (!f) return false;
    size_t w = std::fwrite(p, 1, n, f);
    std::fclose(f);
    return w == n;
}

bool read_file(const std::string& path, uint8_t* p, size_t n) {
    FILE* f = std::fopen(path.c_str(), "rb");
    if (!f) return false;
    size_t r = std::fread(p, 1, n, f);
    std::fclose(f);
    return r == n;
}

// Evict LRU buffers until resident <= budget. mu held.
void enforce_budget(Store* s) {
    while (s->resident > s->budget && !s->lru.empty()) {
        uint64_t victim = s->lru.back();
        auto it = s->bufs.find(victim);
        if (it == s->bufs.end()) { s->lru.pop_back(); continue; }
        Buffer& b = it->second;
        if (b.spilled) { s->lru.pop_back(); continue; }
        char name[64];
        std::snprintf(name, sizeof(name), "/part_%llu.bin",
                      (unsigned long long)s->next_file++);
        b.path = s->spill_dir + name;
        if (!write_file(b.path, b.data.data(), b.nbytes)) return;  // keep in RAM
        b.data.clear();
        b.data.shrink_to_fit();
        b.spilled = true;
        s->resident -= b.nbytes;
        s->spill_count++;
        s->lru.pop_back();
    }
}

void touch(Store* s, uint64_t id, Buffer& b) {
    s->lru.erase(b.lru_it);
    s->lru.push_front(id);
    b.lru_it = s->lru.begin();
}

}  // namespace

extern "C" {

void* ps_create(uint64_t budget_bytes, const char* spill_dir) {
    auto* s = new Store();
    s->budget = budget_bytes;
    s->spill_dir = spill_dir ? spill_dir : "/tmp";
    return s;
}

void ps_destroy(void* h) {
    auto* s = static_cast<Store*>(h);
    for (auto& kv : s->bufs) {
        if (kv.second.spilled) std::remove(kv.second.path.c_str());
    }
    delete s;
}

// Copy nbytes from src into the store under `id` (replaces existing).
int ps_put(void* h, uint64_t id, const uint8_t* src, uint64_t nbytes) {
    auto* s = static_cast<Store*>(h);
    std::lock_guard<std::mutex> g(s->mu);
    auto old = s->bufs.find(id);
    if (old != s->bufs.end()) {
        if (!old->second.spilled) {
            s->resident -= old->second.nbytes;
            s->lru.erase(old->second.lru_it);  // only resident entries are listed
        } else {
            std::remove(old->second.path.c_str());
        }
        s->bufs.erase(old);
    }
    Buffer b;
    b.nbytes = nbytes;
    b.data.assign(src, src + nbytes);
    s->lru.push_front(id);
    b.lru_it = s->lru.begin();
    s->resident += nbytes;
    s->bufs.emplace(id, std::move(b));
    enforce_budget(s);
    return 0;
}

// Copy the buffer into dst (unspilling if needed). Returns nbytes or -1.
int64_t ps_get(void* h, uint64_t id, uint8_t* dst, uint64_t dst_cap) {
    auto* s = static_cast<Store*>(h);
    std::lock_guard<std::mutex> g(s->mu);
    auto it = s->bufs.find(id);
    if (it == s->bufs.end()) return -1;
    Buffer& b = it->second;
    if (b.nbytes > dst_cap) return -1;
    if (b.spilled) {
        b.data.resize(b.nbytes);
        if (!read_file(b.path, b.data.data(), b.nbytes)) return -1;
        std::remove(b.path.c_str());
        b.spilled = false;
        s->resident += b.nbytes;
        s->unspill_count++;
        // spilled buffers are NOT in the LRU list: re-insert
        s->lru.push_front(id);
        b.lru_it = s->lru.begin();
    } else {
        touch(s, id, b);
    }
    std::memcpy(dst, b.data.data(), b.nbytes);
    enforce_budget(s);
    return (int64_t)b.nbytes;
}

int64_t ps_size(void* h, uint64_t id) {
    auto* s = static_cast<Store*>(h);
    std::lock_guard<std::mutex> g(s->mu);
    auto it = s->bufs.find(id);
    return it == s->bufs.end() ? -1 : (int64_t)it->second.nbytes;
}

int ps_drop(void* h, uint64_t id) {
    auto* s = static_cast<Store*>(h);
    std::lock_guard<std::mutex> g(s->mu);
    auto it = s->bufs.find(id);
    if (it == s->bufs.end()) return -1;
    if (it->second.spilled) {
        std::remove(it->second.path.c_str());
    } else {
        s->resident -= it->second.nbytes;
        s->lru.erase(it->second.lru_it);  // only resident entries are listed
    }
    s->bufs.erase(it);
    return 0;
}

// stats: out = {resident_bytes, n_buffers, spill_count, unspill_count}
void ps_stats(void* h, uint64_t* out) {
    auto* s = static_cast<Store*>(h);
    std::lock_guard<std::mutex> g(s->mu);
    out[0] = s->resident;
    out[1] = s->bufs.size();
    out[2] = s->spill_count;
    out[3] = s->unspill_count;
}

// ---- Arrow validity bitmap codecs (interop hot path) ----------------------
void pack_bits(const uint8_t* bools, uint64_t n, uint8_t* out) {
    uint64_t nbytes = (n + 7) / 8;
    std::memset(out, 0, nbytes);
    for (uint64_t i = 0; i < n; i++) {
        out[i >> 3] |= (bools[i] ? 1u : 0u) << (i & 7);
    }
}

void unpack_bits(const uint8_t* bytes, uint64_t n, uint8_t* out) {
    for (uint64_t i = 0; i < n; i++) {
        out[i] = (bytes[i >> 3] >> (i & 7)) & 1u;
    }
}

}  // extern "C"
