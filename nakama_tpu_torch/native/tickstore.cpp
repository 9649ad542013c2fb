// Slot-centric ticket registry — the bulk-bookkeeping tail of the
// matchmaker interval.
//
// The reference maintains per-ticket reverse maps in Go
// (sessionTickets/partyTickets, reference server/matchmaker.go:171-214)
// and unlinks matched tickets one at a time inside the Process loop. At
// the 100k-ticket device pool that per-entry host bookkeeping measured
// ~0.5s/interval in Python (round-2 profile) — this store replaces it
// with flat open-addressing hash tables keyed by 64-bit hashes, updated
// by one bulk call per interval over the matched slot array
// (std::unordered_map's node-per-entry layout measured ~28-57ms for the
// same bulk removal; the flat tables run it in a few ms).
//
// Tables use linear probing with backward-shift deletion (no tombstone
// decay) and allow duplicate keys (a session owns up to MaxTickets
// tickets); lookups scan the contiguous probe chain. Key 0 is the empty
// marker — the Python side guarantees nonzero hashes.
//
// Ids never cross the boundary as strings: the Python side hashes
// ticket/session/party ids to u64 (matchmaker/compile.py hash64) and
// resolves hash->slot->ticket-object through its own slot-indexed object
// array, guarding the (negligible, ~2^-35 at 100k live ids) collision
// case by comparing the resolved object's id.

#include <cstddef>
#include <cstdint>
#include <vector>

namespace {

inline uint64_t mix(uint64_t x) {
    // splitmix64 finalizer: the input hashes are already uniform, this
    // just guards against adversarial low-bit structure.
    x ^= x >> 33;
    x *= 0xff51afd7ed558ccdULL;
    x ^= x >> 33;
    return x;
}

// Open-addressing (key u64, val i32) multi-table: linear probing,
// backward-shift deletion, duplicate keys allowed.
struct Table {
    std::vector<uint64_t> keys;  // 0 = empty
    std::vector<int32_t> vals;
    uint64_t mask = 0;
    size_t size_ = 0;

    void init(size_t want) {
        size_t cap = 16;
        while (cap < want) cap <<= 1;
        keys.assign(cap, 0);
        vals.assign(cap, -1);
        mask = cap - 1;
        size_ = 0;
    }

    inline size_t ideal(uint64_t key) const {
        return static_cast<size_t>(mix(key)) & mask;
    }

    void grow() {
        std::vector<uint64_t> old_k;
        std::vector<int32_t> old_v;
        old_k.swap(keys);
        old_v.swap(vals);
        keys.assign(old_k.size() * 2, 0);
        vals.assign(old_v.size() * 2, -1);
        mask = keys.size() - 1;
        size_ = 0;
        for (size_t i = 0; i < old_k.size(); ++i)
            if (old_k[i]) insert(old_k[i], old_v[i]);
    }

    void insert(uint64_t key, int32_t val) {
        if (size_ * 10 >= keys.size() * 6) grow();  // load < 0.6
        size_t i = ideal(key);
        while (keys[i]) i = (i + 1) & mask;
        keys[i] = key;
        vals[i] = val;
        ++size_;
    }

    bool erase(uint64_t key, int32_t val) {
        size_t i = ideal(key);
        while (keys[i]) {
            if (keys[i] == key && vals[i] == val) {
                backshift(i);
                --size_;
                return true;
            }
            i = (i + 1) & mask;
        }
        return false;
    }

    // Fill the hole by shifting back any later chain entry whose ideal
    // position precedes it past the hole (classic linear-probe delete).
    void backshift(size_t hole) {
        size_t i = (hole + 1) & mask;
        while (keys[i]) {
            size_t home = ideal(keys[i]);
            if (((i - home) & mask) >= ((i - hole) & mask)) {
                keys[hole] = keys[i];
                vals[hole] = vals[i];
                hole = i;
            }
            i = (i + 1) & mask;
        }
        keys[hole] = 0;
        vals[hole] = -1;
    }

    int32_t find_one(uint64_t key) const {
        size_t i = ideal(key);
        while (keys[i]) {
            if (keys[i] == key) return vals[i];
            i = (i + 1) & mask;
        }
        return -1;
    }

    int32_t count(uint64_t key) const {
        int32_t n = 0;
        size_t i = ideal(key);
        while (keys[i]) {
            n += keys[i] == key;
            i = (i + 1) & mask;
        }
        return n;
    }

    int32_t collect(uint64_t key, int32_t* out, int32_t cap) const {
        int32_t n = 0;
        size_t i = ideal(key);
        while (keys[i]) {
            if (keys[i] == key) {
                if (n >= cap) break;
                out[n++] = vals[i];
            }
            i = (i + 1) & mask;
        }
        return n;
    }
};

struct Store {
    int32_t capacity = 0;
    int32_t stride = 0;  // max sessions per ticket
    // Per-slot records, flat.
    std::vector<uint8_t> occupied;
    std::vector<uint64_t> id_hash;
    std::vector<uint64_t> party_hash;
    std::vector<uint64_t> sessions;  // [capacity * stride]
    std::vector<int32_t> n_sessions;
    Table by_id, by_session, by_party;
    int64_t live = 0;
};

}  // namespace

extern "C" {

void* ts_create(int32_t capacity, int32_t stride) {
    Store* st = new Store();
    st->capacity = capacity;
    st->stride = stride;
    size_t cap = static_cast<size_t>(capacity);
    st->occupied.assign(cap, 0);
    st->id_hash.assign(cap, 0);
    st->party_hash.assign(cap, 0);
    st->sessions.assign(cap * static_cast<size_t>(stride), 0);
    st->n_sessions.assign(cap, 0);
    st->by_id.init(cap * 2);
    st->by_session.init(cap * 2);
    st->by_party.init(cap / 4 + 16);
    return st;
}

void ts_destroy(void* h) { delete static_cast<Store*>(h); }

int64_t ts_len(void* h) { return static_cast<Store*>(h)->live; }

// Returns 0 on success, -1 if the id hash is already registered, -2 if
// the slot is occupied or the session count exceeds the stride
// (allocator/caller bug — the caller owns the free list and party-size
// validation).
int32_t ts_add(void* h, int32_t slot, uint64_t id_hash,
               const uint64_t* sessions, int32_t n_sessions,
               uint64_t party_hash) {
    Store* st = static_cast<Store*>(h);
    if (st->by_id.find_one(id_hash) >= 0) return -1;
    if (st->occupied[slot] || n_sessions > st->stride) return -2;
    st->occupied[slot] = 1;
    st->id_hash[slot] = id_hash;
    st->party_hash[slot] = party_hash;
    st->n_sessions[slot] = n_sessions;
    uint64_t* dst =
        st->sessions.data() + static_cast<size_t>(slot) * st->stride;
    for (int32_t i = 0; i < n_sessions; ++i) {
        dst[i] = sessions[i];
        st->by_session.insert(sessions[i], slot);
    }
    st->by_id.insert(id_hash, slot);
    if (party_hash) st->by_party.insert(party_hash, slot);
    ++st->live;
    return 0;
}

// Bulk unregistration: one call per interval over the matched slot
// array. Unoccupied slots are skipped (idempotent).
void ts_remove_slots(void* h, const int32_t* slots, int32_t n) {
    Store* st = static_cast<Store*>(h);
    for (int32_t i = 0; i < n; ++i) {
        int32_t slot = slots[i];
        if (!st->occupied[slot]) continue;
        st->by_id.erase(st->id_hash[slot], slot);
        const uint64_t* sess =
            st->sessions.data() + static_cast<size_t>(slot) * st->stride;
        for (int32_t j = 0; j < st->n_sessions[slot]; ++j)
            st->by_session.erase(sess[j], slot);
        if (st->party_hash[slot])
            st->by_party.erase(st->party_hash[slot], slot);
        st->occupied[slot] = 0;
        --st->live;
    }
}

// Bulk registration — the warm-restart restore path (recovery.py): one
// call re-registers a whole checkpoint snapshot, so rebuilding the
// reverse maps for a 100k-ticket pool is native loop time instead of
// ~100k ctypes round trips. Same per-row semantics as ts_add; stops at
// the first failing row and returns its index (-1 = all registered).
int32_t ts_add_bulk(void* h, const int32_t* slots,
                    const uint64_t* id_hashes,
                    const uint64_t* sessions,  // [n * stride] row-major
                    const int32_t* n_sessions,
                    const uint64_t* party_hashes, int32_t n,
                    int32_t stride) {
    for (int32_t r = 0; r < n; ++r) {
        int32_t rc =
            ts_add(h, slots[r], id_hashes[r],
                   sessions + static_cast<size_t>(r) * stride,
                   n_sessions[r], party_hashes[r]);
        if (rc != 0) return r;
    }
    return -1;
}

int32_t ts_slot_of(void* h, uint64_t id_hash) {
    return static_cast<Store*>(h)->by_id.find_one(id_hash);
}

int32_t ts_session_count(void* h, uint64_t session_hash) {
    return static_cast<Store*>(h)->by_session.count(session_hash);
}

int32_t ts_party_count(void* h, uint64_t party_hash) {
    return static_cast<Store*>(h)->by_party.count(party_hash);
}

int32_t ts_session_slots(void* h, uint64_t session_hash, int32_t* out,
                         int32_t cap) {
    return static_cast<Store*>(h)->by_session.collect(session_hash, out,
                                                      cap);
}

int32_t ts_party_slots(void* h, uint64_t party_hash, int32_t* out,
                       int32_t cap) {
    return static_cast<Store*>(h)->by_party.collect(party_hash, out, cap);
}
}
