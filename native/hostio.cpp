// hostio: native host-side streaming I/O runtime for dspsr_jax.
//
// Equivalent of the reference's host runtime pieces:
//  - PrefetchReader: background-thread block reader with a ring of buffers
//    (the performance role of dsp::Seekable's overlap recycling + the
//    IOManager block loop, Kernel/Classes/Seekable.C:70-222) so the Python
//    host loop never blocks on disk while the device computes.
//  - RingBuffer: POSIX shared-memory ring for live capture handoff between
//    an instrument writer process and the pipeline (the role of the psrdada
//    ring used by dsp::DADABuffer, Kernel/Formats/dada/DADABuffer.C) —
//    simplified protocol, not psrdada binary compatible.
//
// C ABI for ctypes. Build: make -C native

#include <atomic>
#include <condition_variable>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <mutex>
#include <thread>
#include <vector>

#include <fcntl.h>
#include <sys/ipc.h>
#include <sys/mman.h>
#include <sys/sem.h>
#include <sys/shm.h>
#include <sys/stat.h>
#include <time.h>
#include <unistd.h>

extern "C" {

// ---------------------------------------------------------------- prefetch

struct PrefetchReader {
  int fd = -1;
  int64_t header_bytes = 0;
  int64_t file_bytes = 0;
  int64_t block_bytes = 0;
  int64_t stride_bytes = 0;
  int depth = 0;

  std::vector<std::vector<uint8_t>> slots;
  std::vector<int64_t> slot_offset;   // byte offset of the block in each slot
  std::vector<int64_t> slot_valid;    // valid bytes in each slot (rest zero)
  int64_t next_read = 0;              // next block offset to read (producer)
  int64_t head = 0, tail = 0;         // ring indices (filled: [tail, head))
  bool eof = false;
  bool stop_flag = false;

  std::mutex m;
  std::condition_variable cv_space, cv_data;
  std::thread worker;

  void produce() {
    for (;;) {
      std::unique_lock<std::mutex> lk(m);
      cv_space.wait(lk, [&] { return stop_flag || head - tail < depth; });
      if (stop_flag) return;
      int64_t off = next_read;
      if (header_bytes + off >= file_bytes) {
        eof = true;
        cv_data.notify_all();
        return;
      }
      int slot = head % depth;
      next_read += stride_bytes;
      lk.unlock();

      auto& buf = slots[slot];
      int64_t want = block_bytes;
      int64_t avail = file_bytes - (header_bytes + off);
      int64_t take = avail < want ? avail : want;
      int64_t got = 0;
      while (got < take) {
        ssize_t r = pread(fd, buf.data() + got, take - got,
                          header_bytes + off + got);
        if (r <= 0) break;
        got += r;
      }
      if (got < want) memset(buf.data() + got, 0, want - got);

      lk.lock();
      slot_offset[slot] = off;
      slot_valid[slot] = got;
      head++;
      cv_data.notify_all();
    }
  }
};

PrefetchReader* prefetch_open(const char* path, int64_t header_bytes,
                              int64_t block_bytes, int64_t stride_bytes,
                              int depth) {
  int fd = open(path, O_RDONLY);
  if (fd < 0) return nullptr;
  struct stat st;
  if (fstat(fd, &st) != 0) {
    close(fd);
    return nullptr;
  }
  auto* r = new PrefetchReader();
  r->fd = fd;
  r->header_bytes = header_bytes;
  r->file_bytes = st.st_size;
  r->block_bytes = block_bytes;
  r->stride_bytes = stride_bytes;
  r->depth = depth;
  r->slots.resize(depth);
  for (auto& s : r->slots) s.resize(block_bytes);
  r->slot_offset.assign(depth, -1);
  r->slot_valid.assign(depth, 0);
  r->worker = std::thread([r] { r->produce(); });
  return r;
}

// Blocks until the next block is ready; copies it into out.
// Returns valid bytes (0 on end of data), and the block's byte offset.
int64_t prefetch_next(PrefetchReader* r, uint8_t* out, int64_t* offset_out) {
  std::unique_lock<std::mutex> lk(r->m);
  r->cv_data.wait(lk, [&] { return r->head > r->tail || r->eof; });
  if (r->head == r->tail) return 0;  // eof, drained
  int slot = r->tail % r->depth;
  int64_t valid = r->slot_valid[slot];
  if (offset_out) *offset_out = r->slot_offset[slot];
  memcpy(out, r->slots[slot].data(), r->block_bytes);
  r->tail++;
  r->cv_space.notify_one();
  return valid;
}

void prefetch_close(PrefetchReader* r) {
  {
    std::lock_guard<std::mutex> lk(r->m);
    r->stop_flag = true;
  }
  r->cv_space.notify_all();
  r->cv_data.notify_all();
  if (r->worker.joinable()) r->worker.join();
  close(r->fd);
  delete r;
}

// ---------------------------------------------------------------- SHM ring

// Layout in shared memory:
//   [ RingHeader | header_area (hdr_bytes) | data (nbufs * buf_bytes) ]
struct RingHeader {
  uint64_t magic;         // 'DSPRING1'
  int64_t hdr_bytes;      // ASCII observation header area size
  int64_t buf_bytes;      // bytes per data buffer
  int64_t nbufs;
  std::atomic<int64_t> written;   // buffers written (monotonic)
  std::atomic<int64_t> read;      // buffers consumed (monotonic)
  std::atomic<int32_t> eod;       // writer signalled end-of-data
  std::atomic<int32_t> hdr_set;   // header written
};

static const uint64_t RING_MAGIC = 0x31474e4952505344ULL;  // "DSPRING1"

struct Ring {
  int fd = -1;
  size_t total = 0;
  RingHeader* h = nullptr;
  uint8_t* hdr_area = nullptr;
  uint8_t* data = nullptr;
  char name[256];
};

static Ring* ring_map(const char* name, size_t total, bool create) {
  int flags = create ? (O_CREAT | O_RDWR) : O_RDWR;
  int fd = shm_open(name, flags, 0600);
  if (fd < 0) return nullptr;
  if (create && ftruncate(fd, total) != 0) {
    close(fd);
    return nullptr;
  }
  if (!create) {
    struct stat st;
    fstat(fd, &st);
    total = st.st_size;
  }
  void* p = mmap(nullptr, total, PROT_READ | PROT_WRITE, MAP_SHARED, fd, 0);
  if (p == MAP_FAILED) {
    close(fd);
    return nullptr;
  }
  auto* r = new Ring();
  r->fd = fd;
  r->total = total;
  r->h = reinterpret_cast<RingHeader*>(p);
  r->hdr_area = reinterpret_cast<uint8_t*>(p) + sizeof(RingHeader);
  snprintf(r->name, sizeof(r->name), "%s", name);
  return r;
}

Ring* ring_create(const char* name, int64_t hdr_bytes, int64_t buf_bytes,
                  int64_t nbufs) {
  size_t total = sizeof(RingHeader) + hdr_bytes + buf_bytes * nbufs;
  Ring* r = ring_map(name, total, true);
  if (!r) return nullptr;
  new (r->h) RingHeader();
  r->h->magic = RING_MAGIC;
  r->h->hdr_bytes = hdr_bytes;
  r->h->buf_bytes = buf_bytes;
  r->h->nbufs = nbufs;
  r->h->written = 0;
  r->h->read = 0;
  r->h->eod = 0;
  r->h->hdr_set = 0;
  r->data = r->hdr_area + hdr_bytes;
  return r;
}

Ring* ring_connect(const char* name) {
  Ring* r = ring_map(name, 0, false);
  if (!r) return nullptr;
  if (r->h->magic != RING_MAGIC) {
    munmap(r->h, r->total);
    close(r->fd);
    delete r;
    return nullptr;
  }
  r->data = r->hdr_area + r->h->hdr_bytes;
  return r;
}

void ring_write_header(Ring* r, const uint8_t* hdr, int64_t n) {
  if (n > r->h->hdr_bytes) n = r->h->hdr_bytes;
  memcpy(r->hdr_area, hdr, n);
  r->h->hdr_set = 1;
}

int ring_read_header(Ring* r, uint8_t* out, int64_t n) {
  if (!r->h->hdr_set) return 0;
  if (n > r->h->hdr_bytes) n = r->h->hdr_bytes;
  memcpy(out, r->hdr_area, n);
  return 1;
}

// Writer: returns 1 on success, 0 if the ring is full (non-blocking).
int ring_push(Ring* r, const uint8_t* buf) {
  int64_t w = r->h->written.load(std::memory_order_acquire);
  int64_t rd = r->h->read.load(std::memory_order_acquire);
  if (w - rd >= r->h->nbufs) return 0;
  memcpy(r->data + (w % r->h->nbufs) * r->h->buf_bytes, buf, r->h->buf_bytes);
  r->h->written.store(w + 1, std::memory_order_release);
  return 1;
}

// Reader: returns 1 with a buffer, 0 if empty, -1 on end-of-data drained.
int ring_pop(Ring* r, uint8_t* out) {
  int64_t w = r->h->written.load(std::memory_order_acquire);
  int64_t rd = r->h->read.load(std::memory_order_acquire);
  if (rd == w) return r->h->eod.load() ? -1 : 0;
  memcpy(out, r->data + (rd % r->h->nbufs) * r->h->buf_bytes, r->h->buf_bytes);
  r->h->read.store(rd + 1, std::memory_order_release);
  return 1;
}

void ring_set_eod(Ring* r) { r->h->eod = 1; }

int64_t ring_buf_bytes(Ring* r) { return r->h->buf_bytes; }
int64_t ring_hdr_bytes(Ring* r) { return r->h->hdr_bytes; }
int64_t ring_fill(Ring* r) { return r->h->written.load() - r->h->read.load(); }

void ring_close(Ring* r, int unlink_it) {
  char name[256];
  snprintf(name, sizeof(name), "%s", r->name);
  munmap(r->h, r->total);
  close(r->fd);
  if (unlink_it) shm_unlink(name);
  delete r;
}

// -------------------------------------------------- psrdada-style SysV ring
//
// The psrdada library (the transport behind the reference's live input,
// Kernel/Formats/dada/dsp/DADABuffer.h:17-80 + DADABuffer.C
// dada_hdu_set_key/connect/lock_read) moves data through System V IPC:
//
//  - a dada_hdu is a DATA block plus a HEADER block; the data block lives
//    at the user key (default DADA_DEFAULT_BLOCK_KEY = 0x0000dada,
//    psrdada dada_def.h) and the header block at key + 1 (psrdada
//    dada_hdu_create convention; DADABuffer reads the hex key from an INFO
//    file, DADABuffer.C:175-208);
//  - each block is an ipcbuf: a SYNC segment (shmget at the block key)
//    holding the ring geometry and counters, plus nbufs BUFFER segments
//    whose shm keys are RECORDED IN the sync segment (psrdada ipcbuf.c
//    stores per-buffer shmkeys so connecting clients discover them from
//    sync — the key derivation below, key + 0x100*(i+1), is therefore a
//    create-time choice, not part of the wire contract);
//  - flow control is a SysV semaphore set at the block key: a FULL
//    semaphore counting filled buffers and a CLEAR semaphore counting free
//    ones (the roles of psrdada's IPCBUF_FULL/IPCBUF_CLEAR);
//  - the header block carries one DADA_DEFAULT_HEADER_SIZE = 4096-byte
//    ASCII header per transfer (psrdada dada_def.h);
//  - end-of-data is flagged in sync with the final byte count (the role of
//    ipcbuf_enable_eod / sod/eod transfer bookkeeping in ipcsync_t).
//
// NOTE on wire compatibility: this image carries no psrdada to diff
// against, so the ipcsync_t FIELD layout below is this library's own
// (version-tagged); the segment/semaphore topology, key conventions and
// blocking protocol follow psrdada's documented design, so real DAQ
// clients port by pointing their ipcbuf struct at this sync layout.

#define DADA_MAX_BUFS 256
static const uint64_t DADA_SYNC_VERSION = 0x4441444131765455ULL;  // tag

struct DadaSync {
  uint64_t version;
  int32_t semkey;
  int32_t pad0;
  uint64_t nbufs;
  uint64_t bufsz;
  volatile uint64_t w_buf;   // buffers written (monotonic)
  volatile uint64_t r_buf;   // buffers consumed (monotonic)
  volatile int32_t eod;      // writer signalled end of the transfer
  volatile int32_t hdr_set;  // header block written (header ring only)
  uint64_t e_byte;           // total bytes of the transfer at EOD
  int32_t shmkey[DADA_MAX_BUFS];
};

enum { DADA_SEM_FULL = 0, DADA_SEM_CLEAR = 1 };

struct DadaBlock {
  int key = 0;
  int shmid = -1;
  int semid = -1;
  DadaSync* sync = nullptr;
  uint8_t* bufs[DADA_MAX_BUFS] = {nullptr};
  int bufids[DADA_MAX_BUFS];
};

static int dada_sem_op(int semid, int sem, int delta, double timeout_s) {
  struct sembuf op;
  op.sem_num = (unsigned short)sem;
  op.sem_op = (short)delta;
  op.sem_flg = 0;
  if (timeout_s < 0) return semop(semid, &op, 1);
  struct timespec ts;
  ts.tv_sec = (time_t)timeout_s;
  ts.tv_nsec = (long)((timeout_s - (double)ts.tv_sec) * 1e9);
  return semtimedop(semid, &op, 1, &ts);
}

static DadaBlock* dada_block_create(int key, uint64_t nbufs, uint64_t bufsz) {
  if (nbufs > DADA_MAX_BUFS) return nullptr;
  auto* b = new DadaBlock();
  b->key = key;
  b->shmid = shmget(key, sizeof(DadaSync), IPC_CREAT | IPC_EXCL | 0600);
  if (b->shmid < 0) {  // stale segment: adopt and reset
    b->shmid = shmget(key, sizeof(DadaSync), IPC_CREAT | 0600);
  }
  if (b->shmid < 0) { delete b; return nullptr; }
  b->sync = (DadaSync*)shmat(b->shmid, nullptr, 0);
  if (b->sync == (void*)-1) { delete b; return nullptr; }
  memset((void*)b->sync, 0, sizeof(DadaSync));
  b->sync->version = DADA_SYNC_VERSION;
  b->sync->semkey = key;
  b->sync->nbufs = nbufs;
  b->sync->bufsz = bufsz;
  for (uint64_t i = 0; i < nbufs; i++) {
    int bk = key + 0x100 * (int)(i + 1);
    b->sync->shmkey[i] = bk;
    b->bufids[i] = shmget(bk, bufsz, IPC_CREAT | 0600);
    if (b->bufids[i] < 0) { delete b; return nullptr; }
    b->bufs[i] = (uint8_t*)shmat(b->bufids[i], nullptr, 0);
    if (b->bufs[i] == (void*)-1) { delete b; return nullptr; }
  }
  b->semid = semget(key, 2, IPC_CREAT | 0600);
  if (b->semid < 0) { delete b; return nullptr; }
  // FULL = 0 filled, CLEAR = nbufs free
  semctl(b->semid, DADA_SEM_FULL, SETVAL, 0);
  semctl(b->semid, DADA_SEM_CLEAR, SETVAL, (int)nbufs);
  return b;
}

static DadaBlock* dada_block_connect(int key) {
  auto* b = new DadaBlock();
  b->key = key;
  b->shmid = shmget(key, sizeof(DadaSync), 0600);
  if (b->shmid < 0) { delete b; return nullptr; }
  b->sync = (DadaSync*)shmat(b->shmid, nullptr, 0);
  if (b->sync == (void*)-1 || b->sync->version != DADA_SYNC_VERSION) {
    delete b; return nullptr;
  }
  for (uint64_t i = 0; i < b->sync->nbufs; i++) {
    b->bufids[i] = shmget(b->sync->shmkey[i], b->sync->bufsz, 0600);
    if (b->bufids[i] < 0) { delete b; return nullptr; }
    b->bufs[i] = (uint8_t*)shmat(b->bufids[i], nullptr, 0);
    if (b->bufs[i] == (void*)-1) { delete b; return nullptr; }
  }
  b->semid = semget(b->sync->semkey, 2, 0600);
  if (b->semid < 0) { delete b; return nullptr; }
  return b;
}

static void dada_block_close(DadaBlock* b, int destroy) {
  if (!b) return;
  uint64_t nbufs = b->sync ? b->sync->nbufs : 0;
  for (uint64_t i = 0; i < nbufs; i++) {
    if (b->bufs[i]) shmdt(b->bufs[i]);
    if (destroy && b->bufids[i] >= 0) shmctl(b->bufids[i], IPC_RMID, nullptr);
  }
  if (b->sync) shmdt((void*)b->sync);
  if (destroy) {
    if (b->shmid >= 0) shmctl(b->shmid, IPC_RMID, nullptr);
    if (b->semid >= 0) semctl(b->semid, 0, IPC_RMID);
  }
  delete b;
}

// --- the hdu: data block at key, header block at key + 1 ---

struct DadaHdu {
  DadaBlock* data = nullptr;
  DadaBlock* header = nullptr;
};

DadaHdu* dada_create(int key, int64_t nbufs, int64_t bufsz,
                     int64_t hdr_bufsz) {
  auto* h = new DadaHdu();
  h->data = dada_block_create(key, (uint64_t)nbufs, (uint64_t)bufsz);
  h->header = dada_block_create(key + 1, 1, (uint64_t)hdr_bufsz);
  if (!h->data || !h->header) {
    dada_block_close(h->data, 1);
    dada_block_close(h->header, 1);
    delete h;
    return nullptr;
  }
  return h;
}

DadaHdu* dada_connect(int key) {
  auto* h = new DadaHdu();
  h->data = dada_block_connect(key);
  h->header = dada_block_connect(key + 1);
  if (!h->data || !h->header) {
    dada_block_close(h->data, 0);
    dada_block_close(h->header, 0);
    delete h;
    return nullptr;
  }
  return h;
}

void dada_write_header(DadaHdu* h, const uint8_t* hdr, int64_t n) {
  uint64_t cap = h->header->sync->bufsz;
  if ((uint64_t)n > cap) n = (int64_t)cap;
  memcpy(h->header->bufs[0], hdr, n);
  if ((uint64_t)n < cap) memset(h->header->bufs[0] + n, 0, cap - n);
  __sync_synchronize();
  h->header->sync->hdr_set = 1;
}

int dada_read_header(DadaHdu* h, uint8_t* out, int64_t n) {
  if (!h->header->sync->hdr_set) return 0;
  uint64_t cap = h->header->sync->bufsz;
  if ((uint64_t)n > cap) n = (int64_t)cap;
  __sync_synchronize();
  memcpy(out, h->header->bufs[0], n);
  return 1;
}

// Writer: blocks up to timeout_s for a free buffer; 1 = written, 0 = timeout.
int dada_push(DadaHdu* h, const uint8_t* buf, double timeout_s) {
  DadaBlock* d = h->data;
  if (dada_sem_op(d->semid, DADA_SEM_CLEAR, -1, timeout_s) != 0) return 0;
  uint64_t w = d->sync->w_buf;
  memcpy(d->bufs[w % d->sync->nbufs], buf, d->sync->bufsz);
  __sync_synchronize();
  d->sync->w_buf = w + 1;
  dada_sem_op(d->semid, DADA_SEM_FULL, +1, -1);
  return 1;
}

// Reader: 1 = buffer read, 0 = timeout, -1 = end-of-data drained.
int dada_pop(DadaHdu* h, uint8_t* out, double timeout_s) {
  DadaBlock* d = h->data;
  for (;;) {
    if (dada_sem_op(d->semid, DADA_SEM_FULL, -1, timeout_s) == 0) break;
    if (d->sync->eod && d->sync->r_buf == d->sync->w_buf) return -1;
    return 0;
  }
  uint64_t r = d->sync->r_buf;
  __sync_synchronize();
  memcpy(out, d->bufs[r % d->sync->nbufs], d->sync->bufsz);
  d->sync->r_buf = r + 1;
  dada_sem_op(d->semid, DADA_SEM_CLEAR, +1, -1);
  return 1;
}

void dada_set_eod(DadaHdu* h) {
  DadaSync* s = h->data->sync;
  s->e_byte = s->w_buf * s->bufsz;
  __sync_synchronize();
  s->eod = 1;
}

int64_t dada_bufsz(DadaHdu* h) { return (int64_t)h->data->sync->bufsz; }
int64_t dada_nbufs(DadaHdu* h) { return (int64_t)h->data->sync->nbufs; }
int64_t dada_hdr_bufsz(DadaHdu* h) {
  return (int64_t)h->header->sync->bufsz;
}
int64_t dada_fill(DadaHdu* h) {
  return (int64_t)(h->data->sync->w_buf - h->data->sync->r_buf);
}

void dada_close(DadaHdu* h, int destroy) {
  dada_block_close(h->data, destroy);
  dada_block_close(h->header, destroy);
  delete h;
}

}  // extern "C"
