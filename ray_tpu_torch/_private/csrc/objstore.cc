// ray_tpu_torch shared-memory object store: the port's copy of src/objstore.cc.
//
// Role-equivalent of the reference's plasma store (reference
// src/ray/object_manager/plasma/: PlasmaClient client.h:146, allocator
// plasma_allocator.cc, eviction eviction_policy.cc, lifecycle
// object_lifecycle_manager.h) but with a different architecture chosen for
// lower latency on a TPU host: instead of a store *process* speaking a
// flatbuffer socket protocol, the entire store — object table, boundary-tag
// heap allocator, LRU eviction list, and synchronization — lives inside one
// shared-memory segment.  Every participant (driver, workers, node manager)
// maps the segment and performs create/seal/get/release as direct memory
// operations under a process-shared robust mutex; "wait for sealed" uses a
// process-shared condition variable.  Reads are zero-copy: get() returns the
// offset of the object payload inside the mapping.
//
// All cross-process references are offsets (the segment maps at different
// addresses in different processes).
//
// C API at the bottom; Python binds via ctypes (ray_tpu_torch/_private/object_store.py).

#include <errno.h>
#include <fcntl.h>
#include <pthread.h>
#include <stdint.h>
#include <string.h>
#include <sys/mman.h>
#include <sys/stat.h>
#include <time.h>
#include <unistd.h>

#include <atomic>
#include <cstdio>

namespace {

constexpr uint64_t kMagic = 0x5241595450553031ULL;  // "RAYTPU01"
constexpr uint32_t kIdSize = 24;                    // ObjectID bytes
constexpr uint64_t kAlign = 64;                     // payload alignment
constexpr uint32_t kNil = 0xFFFFFFFFu;              // null entry index

// ---- errors (mirror a Status enum; returned as negative ints) ----
enum {
  OS_OK = 0,
  OS_ERR_EXISTS = -1,
  OS_ERR_NOT_FOUND = -2,
  OS_ERR_FULL = -3,
  OS_ERR_TIMEOUT = -4,
  OS_ERR_STATE = -5,   // e.g. seal of already-sealed
  OS_ERR_INVAL = -6,
  OS_ERR_SYS = -7,
};

enum ObjState : uint32_t { STATE_FREE = 0, STATE_CREATED = 1, STATE_SEALED = 2 };

struct Entry {
  uint8_t id[kIdSize];
  uint32_t state;
  uint32_t hash_next;   // chain in bucket
  uint64_t data_off;    // offset of payload in segment
  uint64_t data_size;   // user data bytes
  uint64_t meta_size;   // trailing metadata bytes (payload = data ++ meta)
  int64_t refcount;     // pinned while > 0
  uint32_t lru_prev, lru_next;  // LRU list when sealed & refcount==0
  uint64_t seq;         // monotonically increasing seal sequence (for stats)
};

// Free heap block header (boundary-tag allocator). Blocks live in the data
// heap region; headers are in-band. prev_off supports coalescing. Payloads
// start kHdr (= kAlign) bytes into the block so they are 64-byte aligned —
// zero-copy consumers (numpy/dlpack) get aligned pointers.
struct Block {
  uint64_t size;        // total block size incl. header; low bit = in-use
  uint64_t prev_off;    // offset of previous (lower-address) block, 0 if first
};
constexpr uint64_t kHdr = kAlign;  // payload offset within a block
// For the free list we chain by offset (64-bit), stored right after the
// Block header of a free block.
struct FreeLinks {
  uint64_t next_off;  // 0 = end
  uint64_t prev_off;
};

struct Header {
  uint64_t magic;
  uint64_t capacity;        // total segment size
  uint64_t heap_off;        // start of data heap
  uint64_t heap_size;
  uint32_t nbuckets;
  uint32_t nentries;
  uint64_t buckets_off;     // uint32_t[nbuckets]
  uint64_t entries_off;     // Entry[nentries]
  pthread_mutex_t mu;
  pthread_cond_t cv;        // broadcast on seal/delete
  // stats / state
  std::atomic<uint64_t> bytes_used;
  std::atomic<uint64_t> num_objects;
  std::atomic<uint64_t> seal_seq;
  std::atomic<uint64_t> evictions;
  uint64_t free_head_off;   // first free heap block (0 = none)
  uint32_t entry_free_head; // free entry list head (kNil = none)
  uint32_t lru_head, lru_tail;  // LRU of evictable entries
};

struct Store {
  Header* h;
  uint8_t* base;
  uint64_t map_size;
  int fd;
  bool owner;
};

inline uint64_t align_up(uint64_t v, uint64_t a) { return (v + a - 1) & ~(a - 1); }

inline Entry* entries(Store* s) {
  return reinterpret_cast<Entry*>(s->base + s->h->entries_off);
}
inline uint32_t* buckets(Store* s) {
  return reinterpret_cast<uint32_t*>(s->base + s->h->buckets_off);
}
inline Block* block_at(Store* s, uint64_t off) {
  return reinterpret_cast<Block*>(s->base + off);
}
inline FreeLinks* links_of(Store* s, uint64_t off) {
  return reinterpret_cast<FreeLinks*>(s->base + off + sizeof(Block));
}

inline uint64_t hash_id(const uint8_t* id) {
  // FNV-1a over the 24-byte id.
  uint64_t h = 1469598103934665603ULL;
  for (uint32_t i = 0; i < kIdSize; i++) { h ^= id[i]; h *= 1099511628211ULL; }
  return h;
}

// ---------- free-list heap ----------

void freelist_insert(Store* s, uint64_t off) {
  Block* b = block_at(s, off);
  b->size &= ~1ULL;
  FreeLinks* l = links_of(s, off);
  l->next_off = s->h->free_head_off;
  l->prev_off = 0;
  if (s->h->free_head_off) links_of(s, s->h->free_head_off)->prev_off = off;
  s->h->free_head_off = off;
}

void freelist_remove(Store* s, uint64_t off) {
  FreeLinks* l = links_of(s, off);
  if (l->prev_off) links_of(s, l->prev_off)->next_off = l->next_off;
  else s->h->free_head_off = l->next_off;
  if (l->next_off) links_of(s, l->next_off)->prev_off = l->prev_off;
}

// allocate `need` payload bytes; returns payload offset or 0 on failure.
uint64_t heap_alloc(Store* s, uint64_t need) {
  uint64_t total = align_up(need, kAlign) + kHdr;
  // first-fit scan
  uint64_t off = s->h->free_head_off;
  while (off) {
    Block* b = block_at(s, off);
    uint64_t bsize = b->size & ~1ULL;
    if (bsize >= total) {
      freelist_remove(s, off);
      uint64_t rem = bsize - total;
      if (rem >= sizeof(Block) + kAlign) {
        // split: tail becomes a new free block
        uint64_t tail_off = off + total;
        Block* tail = block_at(s, tail_off);
        tail->size = rem;
        tail->prev_off = off;
        // fix next-neighbor's prev
        uint64_t nn = tail_off + rem;
        if (nn < s->h->heap_off + s->h->heap_size) block_at(s, nn)->prev_off = tail_off;
        freelist_insert(s, tail_off);
        b->size = total | 1ULL;
      } else {
        b->size = bsize | 1ULL;
      }
      return off + kHdr;
    }
    off = links_of(s, off)->next_off;
  }
  return 0;
}

void heap_free(Store* s, uint64_t payload_off) {
  uint64_t off = payload_off - kHdr;
  Block* b = block_at(s, off);
  uint64_t bsize = b->size & ~1ULL;
  uint64_t heap_end = s->h->heap_off + s->h->heap_size;
  // coalesce with next
  uint64_t next_off = off + bsize;
  if (next_off < heap_end) {
    Block* nb = block_at(s, next_off);
    if (!(nb->size & 1ULL)) {
      freelist_remove(s, next_off);
      bsize += nb->size & ~1ULL;
      uint64_t nn = off + bsize;
      if (nn < heap_end) block_at(s, nn)->prev_off = off;
    }
  }
  // coalesce with prev
  if (b->prev_off || off != s->h->heap_off) {
    uint64_t prev_off = b->prev_off;
    if (prev_off) {
      Block* pb = block_at(s, prev_off);
      if (!(pb->size & 1ULL)) {
        freelist_remove(s, prev_off);
        uint64_t psz = pb->size & ~1ULL;
        pb->size = psz + bsize;
        uint64_t nn = prev_off + pb->size;
        if (nn < heap_end) block_at(s, nn)->prev_off = prev_off;
        freelist_insert(s, prev_off);
        return;
      }
    }
  }
  b->size = bsize;
  freelist_insert(s, off);
}

// ---------- entry table ----------

uint32_t entry_alloc(Store* s) {
  uint32_t i = s->h->entry_free_head;
  if (i == kNil) return kNil;
  s->h->entry_free_head = entries(s)[i].hash_next;
  return i;
}

void entry_release(Store* s, uint32_t i) {
  Entry* e = &entries(s)[i];
  e->state = STATE_FREE;
  e->hash_next = s->h->entry_free_head;
  s->h->entry_free_head = i;
}

uint32_t lookup(Store* s, const uint8_t* id) {
  uint32_t b = hash_id(id) % s->h->nbuckets;
  uint32_t i = buckets(s)[b];
  while (i != kNil) {
    Entry* e = &entries(s)[i];
    if (memcmp(e->id, id, kIdSize) == 0) return i;
    i = e->hash_next;
  }
  return kNil;
}

void table_insert(Store* s, uint32_t idx) {
  Entry* e = &entries(s)[idx];
  uint32_t b = hash_id(e->id) % s->h->nbuckets;
  e->hash_next = buckets(s)[b];
  buckets(s)[b] = idx;
}

void table_remove(Store* s, uint32_t idx) {
  Entry* e = &entries(s)[idx];
  uint32_t b = hash_id(e->id) % s->h->nbuckets;
  uint32_t i = buckets(s)[b];
  uint32_t prev = kNil;
  while (i != kNil) {
    if (i == idx) {
      if (prev == kNil) buckets(s)[b] = e->hash_next;
      else entries(s)[prev].hash_next = e->hash_next;
      return;
    }
    prev = i;
    i = entries(s)[i].hash_next;
  }
}

// ---------- LRU (evictable = sealed && refcount==0) ----------

void lru_push(Store* s, uint32_t idx) {  // most-recently-released at tail
  Entry* e = &entries(s)[idx];
  e->lru_prev = s->h->lru_tail;
  e->lru_next = kNil;
  if (s->h->lru_tail != kNil) entries(s)[s->h->lru_tail].lru_next = idx;
  s->h->lru_tail = idx;
  if (s->h->lru_head == kNil) s->h->lru_head = idx;
}

void lru_remove(Store* s, uint32_t idx) {
  Entry* e = &entries(s)[idx];
  if (e->lru_prev != kNil) entries(s)[e->lru_prev].lru_next = e->lru_next;
  else if (s->h->lru_head == idx) s->h->lru_head = e->lru_next;
  if (e->lru_next != kNil) entries(s)[e->lru_next].lru_prev = e->lru_prev;
  else if (s->h->lru_tail == idx) s->h->lru_tail = e->lru_prev;
  e->lru_prev = e->lru_next = kNil;
}

void delete_entry_locked(Store* s, uint32_t idx) {
  Entry* e = &entries(s)[idx];
  heap_free(s, e->data_off);
  s->h->bytes_used.fetch_sub(e->data_size + e->meta_size);
  s->h->num_objects.fetch_sub(1);
  table_remove(s, idx);
  entry_release(s, idx);
}

// evict LRU-first until `need` payload bytes are allocatable; returns alloc.
uint64_t alloc_with_eviction(Store* s, uint64_t need) {
  uint64_t off = heap_alloc(s, need);
  while (off == 0) {
    uint32_t victim = s->h->lru_head;
    if (victim == kNil) return 0;
    lru_remove(s, victim);
    delete_entry_locked(s, victim);
    s->h->evictions.fetch_add(1);
    off = heap_alloc(s, need);
  }
  return off;
}

struct Guard {
  pthread_mutex_t* m;
  explicit Guard(pthread_mutex_t* mu) : m(mu) {
    int rc = pthread_mutex_lock(m);
    if (rc == EOWNERDEAD) pthread_mutex_consistent(m);  // robust: prior holder died
  }
  ~Guard() { pthread_mutex_unlock(m); }
};

}  // namespace

extern "C" {

// Create a new store segment at shm name `name` with `capacity` bytes.
// Returns an opaque handle or nullptr.
void* os_create(const char* name, uint64_t capacity) {
  shm_unlink(name);
  int fd = shm_open(name, O_CREAT | O_EXCL | O_RDWR, 0600);
  if (fd < 0) return nullptr;
  if (ftruncate(fd, (off_t)capacity) != 0) { close(fd); shm_unlink(name); return nullptr; }
  void* mem = mmap(nullptr, capacity, PROT_READ | PROT_WRITE, MAP_SHARED, fd, 0);
  if (mem == MAP_FAILED) { close(fd); shm_unlink(name); return nullptr; }

  auto* s = new Store();
  s->base = static_cast<uint8_t*>(mem);
  s->h = reinterpret_cast<Header*>(mem);
  s->map_size = capacity;
  s->fd = fd;
  s->owner = true;

  Header* h = s->h;
  memset(h, 0, sizeof(Header));
  h->capacity = capacity;
  // size the tables: one entry per 16KiB of capacity, min 4096; buckets 2x.
  uint32_t nentries = (uint32_t)(capacity / 16384);
  if (nentries < 4096) nentries = 4096;
  if (nentries > (1u << 22)) nentries = 1u << 22;
  h->nentries = nentries;
  h->nbuckets = nentries * 2;
  uint64_t off = align_up(sizeof(Header), kAlign);
  h->buckets_off = off;
  off = align_up(off + sizeof(uint32_t) * (uint64_t)h->nbuckets, kAlign);
  h->entries_off = off;
  off = align_up(off + sizeof(Entry) * (uint64_t)h->nentries, kAlign);
  h->heap_off = off;
  if (off + 2 * kAlign + sizeof(Block) >= capacity) {  // capacity too small
    delete s; munmap(mem, capacity); close(fd); shm_unlink(name); return nullptr;
  }
  h->heap_size = capacity - off;

  // init sync primitives as process-shared + robust
  pthread_mutexattr_t ma;
  pthread_mutexattr_init(&ma);
  pthread_mutexattr_setpshared(&ma, PTHREAD_PROCESS_SHARED);
  pthread_mutexattr_setrobust(&ma, PTHREAD_MUTEX_ROBUST);
  pthread_mutex_init(&h->mu, &ma);
  pthread_condattr_t ca;
  pthread_condattr_init(&ca);
  pthread_condattr_setpshared(&ca, PTHREAD_PROCESS_SHARED);
  pthread_condattr_setclock(&ca, CLOCK_MONOTONIC);
  pthread_cond_init(&h->cv, &ca);

  // buckets + entry free list
  uint32_t* bk = buckets(s);
  for (uint32_t i = 0; i < h->nbuckets; i++) bk[i] = kNil;
  Entry* es = entries(s);
  for (uint32_t i = 0; i < h->nentries; i++) {
    es[i].state = STATE_FREE;
    es[i].hash_next = (i + 1 < h->nentries) ? i + 1 : kNil;
  }
  h->entry_free_head = 0;
  h->lru_head = h->lru_tail = kNil;

  // one giant free block
  Block* b0 = block_at(s, h->heap_off);
  b0->size = h->heap_size;
  b0->prev_off = 0;
  h->free_head_off = 0;
  freelist_insert(s, h->heap_off);

  h->magic = kMagic;  // last: marks the segment valid for attachers
  return s;
}

void* os_attach(const char* name) {
  int fd = shm_open(name, O_RDWR, 0600);
  if (fd < 0) return nullptr;
  struct stat st;
  if (fstat(fd, &st) != 0) { close(fd); return nullptr; }
  void* mem = mmap(nullptr, st.st_size, PROT_READ | PROT_WRITE, MAP_SHARED, fd, 0);
  if (mem == MAP_FAILED) { close(fd); return nullptr; }
  auto* s = new Store();
  s->base = static_cast<uint8_t*>(mem);
  s->h = reinterpret_cast<Header*>(mem);
  s->map_size = st.st_size;
  s->fd = fd;
  s->owner = false;
  if (s->h->magic != kMagic) { munmap(mem, st.st_size); close(fd); delete s; return nullptr; }
  return s;
}

void os_detach(void* sp) {
  auto* s = static_cast<Store*>(sp);
  munmap(s->base, s->map_size);
  close(s->fd);
  delete s;
}

void os_destroy(void* sp, const char* name) {
  os_detach(sp);
  shm_unlink(name);
}

// Base pointer of the mapping in THIS process (payload ptr = base + offset).
uint8_t* os_base(void* sp) { return static_cast<Store*>(sp)->base; }
uint64_t os_capacity(void* sp) { return static_cast<Store*>(sp)->h->capacity; }

// Create an object (state CREATED, pinned by creator). Returns payload
// offset (>0) or negative error. Total payload = data_size + meta_size.
// allow_evict=0 returns OS_ERR_FULL instead of silently evicting LRU
// objects, so the client can spill victims to disk first (reference:
// plasma prefers SpillObjectsOfSize over eviction when spilling is
// configured, local_object_manager.h:206 / create_request_queue.cc).
int64_t os_obj_create2(void* sp, const uint8_t* id, uint64_t data_size,
                       uint64_t meta_size, int allow_evict) {
  auto* s = static_cast<Store*>(sp);
  Guard g(&s->h->mu);
  if (lookup(s, id) != kNil) return OS_ERR_EXISTS;
  uint32_t idx = entry_alloc(s);
  while (idx == kNil) {  // entry table exhausted: evict to reclaim entries
    uint32_t victim = s->h->lru_head;
    if (victim == kNil || !allow_evict) return OS_ERR_FULL;
    lru_remove(s, victim);
    delete_entry_locked(s, victim);
    s->h->evictions.fetch_add(1);
    idx = entry_alloc(s);
  }
  uint64_t need = data_size + meta_size;
  if (need == 0) need = 1;  // zero-size objects still get a slot
  uint64_t off = allow_evict ? alloc_with_eviction(s, need)
                             : heap_alloc(s, need);
  if (off == 0) { entry_release(s, idx); return OS_ERR_FULL; }
  Entry* e = &entries(s)[idx];
  memcpy(e->id, id, kIdSize);
  e->state = STATE_CREATED;
  e->data_off = off;
  e->data_size = data_size;
  e->meta_size = meta_size;
  e->refcount = 1;  // creator pin
  e->lru_prev = e->lru_next = kNil;
  table_insert(s, idx);
  s->h->bytes_used.fetch_add(data_size + meta_size);
  s->h->num_objects.fetch_add(1);
  return (int64_t)off;
}

int64_t os_obj_create(void* sp, const uint8_t* id, uint64_t data_size,
                      uint64_t meta_size) {
  return os_obj_create2(sp, id, data_size, meta_size, 1);
}

// Seal: object becomes immutable & readable; creator pin is dropped.
int64_t os_obj_seal(void* sp, const uint8_t* id) {
  auto* s = static_cast<Store*>(sp);
  Guard g(&s->h->mu);
  uint32_t idx = lookup(s, id);
  if (idx == kNil) return OS_ERR_NOT_FOUND;
  Entry* e = &entries(s)[idx];
  if (e->state != STATE_CREATED) return OS_ERR_STATE;
  e->state = STATE_SEALED;
  e->seq = s->h->seal_seq.fetch_add(1) + 1;
  e->refcount -= 1;
  if (e->refcount == 0) lru_push(s, idx);
  pthread_cond_broadcast(&s->h->cv);
  return OS_OK;
}

// Get: wait up to timeout_ms for the object to be sealed; pins it and
// returns payload offset; sizes returned through out params.
// timeout_ms < 0: wait forever; == 0: non-blocking.
int64_t os_obj_get(void* sp, const uint8_t* id, int64_t timeout_ms,
                   uint64_t* data_size, uint64_t* meta_size) {
  auto* s = static_cast<Store*>(sp);
  struct timespec deadline;
  if (timeout_ms > 0) {
    clock_gettime(CLOCK_MONOTONIC, &deadline);
    deadline.tv_sec += timeout_ms / 1000;
    deadline.tv_nsec += (timeout_ms % 1000) * 1000000L;
    if (deadline.tv_nsec >= 1000000000L) { deadline.tv_sec++; deadline.tv_nsec -= 1000000000L; }
  }
  Guard g(&s->h->mu);
  for (;;) {
    uint32_t idx = lookup(s, id);
    if (idx != kNil) {
      Entry* e = &entries(s)[idx];
      if (e->state == STATE_SEALED) {
        if (e->refcount == 0) lru_remove(s, idx);
        e->refcount += 1;
        *data_size = e->data_size;
        *meta_size = e->meta_size;
        return (int64_t)e->data_off;
      }
    }
    if (timeout_ms == 0) return OS_ERR_TIMEOUT;
    int rc;
    if (timeout_ms < 0) {
      rc = pthread_cond_wait(&s->h->cv, &s->h->mu);
    } else {
      rc = pthread_cond_timedwait(&s->h->cv, &s->h->mu, &deadline);
      if (rc == ETIMEDOUT) return OS_ERR_TIMEOUT;
    }
    if (rc == EOWNERDEAD) pthread_mutex_consistent(&s->h->mu);
  }
}

int64_t os_obj_release(void* sp, const uint8_t* id) {
  auto* s = static_cast<Store*>(sp);
  Guard g(&s->h->mu);
  uint32_t idx = lookup(s, id);
  if (idx == kNil) return OS_ERR_NOT_FOUND;
  Entry* e = &entries(s)[idx];
  if (e->refcount <= 0) return OS_ERR_STATE;
  e->refcount -= 1;
  if (e->refcount == 0 && e->state == STATE_SEALED) lru_push(s, idx);
  return OS_OK;
}

// Abort an un-sealed create (e.g. serialization failed mid-write).
int64_t os_obj_abort(void* sp, const uint8_t* id) {
  auto* s = static_cast<Store*>(sp);
  Guard g(&s->h->mu);
  uint32_t idx = lookup(s, id);
  if (idx == kNil) return OS_ERR_NOT_FOUND;
  Entry* e = &entries(s)[idx];
  if (e->state != STATE_CREATED) return OS_ERR_STATE;
  delete_entry_locked(s, idx);
  return OS_OK;
}

// Delete a sealed object if unpinned; OS_ERR_STATE if pinned (caller may
// retry after releases).
int64_t os_obj_delete(void* sp, const uint8_t* id) {
  auto* s = static_cast<Store*>(sp);
  Guard g(&s->h->mu);
  uint32_t idx = lookup(s, id);
  if (idx == kNil) return OS_ERR_NOT_FOUND;
  Entry* e = &entries(s)[idx];
  if (e->refcount > 0) return OS_ERR_STATE;
  if (e->state == STATE_SEALED) lru_remove(s, idx);
  delete_entry_locked(s, idx);
  pthread_cond_broadcast(&s->h->cv);
  return OS_OK;
}

// contains: 1 sealed, 0 absent/unsealed.
int64_t os_obj_contains(void* sp, const uint8_t* id) {
  auto* s = static_cast<Store*>(sp);
  Guard g(&s->h->mu);
  uint32_t idx = lookup(s, id);
  if (idx == kNil) return 0;
  return entries(s)[idx].state == STATE_SEALED ? 1 : 0;
}

// Evict up to nbytes of LRU unpinned sealed objects; returns bytes evicted.
int64_t os_evict(void* sp, uint64_t nbytes) {
  auto* s = static_cast<Store*>(sp);
  Guard g(&s->h->mu);
  uint64_t freed = 0;
  while (freed < nbytes) {
    uint32_t victim = s->h->lru_head;
    if (victim == kNil) break;
    Entry* e = &entries(s)[victim];
    freed += e->data_size + e->meta_size;
    lru_remove(s, victim);
    delete_entry_locked(s, victim);
    s->h->evictions.fetch_add(1);
  }
  return (int64_t)freed;
}

// List LRU unpinned sealed object ids (oldest first) totaling >= nbytes,
// WITHOUT deleting them.  Fills out_ids (max_out * kIdSize bytes) and
// out_sizes; returns the count.  The caller spills them to disk and then
// deletes — the spill analog of os_evict (reference: the raylet picks
// spill victims from plasma's eviction order, local_object_manager.h:206
// SpillObjectsOfSize).
int64_t os_lru_candidates(void* sp, uint64_t nbytes, uint8_t* out_ids,
                          uint64_t* out_sizes, int64_t max_out) {
  auto* s = static_cast<Store*>(sp);
  Guard g(&s->h->mu);
  uint64_t acc = 0;
  int64_t n = 0;
  uint32_t cur = s->h->lru_head;
  while (cur != kNil && n < max_out && acc < nbytes) {
    Entry* e = &entries(s)[cur];
    memcpy(out_ids + n * kIdSize, e->id, kIdSize);
    uint64_t sz = e->data_size + e->meta_size;
    out_sizes[n] = sz;
    acc += sz;
    n++;
    cur = e->lru_next;
  }
  return n;
}

void os_stats(void* sp, uint64_t* bytes_used, uint64_t* num_objects,
              uint64_t* capacity, uint64_t* evictions) {
  auto* s = static_cast<Store*>(sp);
  *bytes_used = s->h->bytes_used.load();
  *num_objects = s->h->num_objects.load();
  *capacity = s->h->capacity;
  *evictions = s->h->evictions.load();
}

}  // extern "C"
