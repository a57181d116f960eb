// Native data plane of the port's object store: POSIX shared-memory segments
// (the port's own copy of raydp_tpu/store/native/store.cpp).
//
// Blocks of Arrow IPC bytes move between processes through /dev/shm with no
// serialization beyond the Arrow encode itself. Metadata (ownership, sizes,
// GC) lives in the head process; this library only creates, maps and
// unlinks segments. It is host code, built with g++ at first use
// (store/object_store.py).
//
// Writers stream Arrow IPC directly into a created segment (no staging copy):
// create -> write via mapped pointer -> finalize(actual_size). Readers map
// read-only and hand the pointer to pyarrow as a foreign buffer (zero-copy).

#include <cerrno>
#include <cstdint>
#include <cstring>

#include <fcntl.h>
#include <sys/mman.h>
#include <sys/stat.h>
#include <unistd.h>

extern "C" {

// Create a segment of `size` bytes and map it read-write.
// Returns the mapped pointer, or nullptr (errno preserved) on failure.
void* rtpu_shm_create(const char* name, uint64_t size) {
  int fd = shm_open(name, O_CREAT | O_EXCL | O_RDWR, 0600);
  if (fd < 0) return nullptr;
  if (ftruncate(fd, static_cast<off_t>(size)) != 0) {
    int saved = errno;
    close(fd);
    shm_unlink(name);
    errno = saved;
    return nullptr;
  }
  void* ptr = mmap(nullptr, size, PROT_READ | PROT_WRITE, MAP_SHARED, fd, 0);
  close(fd);
  if (ptr == MAP_FAILED) {
    int saved = errno;
    shm_unlink(name);
    errno = saved;
    return nullptr;
  }
  return ptr;
}

// Shrink a finished segment to the bytes actually written. The caller's
// mapping (of the original size) stays valid for the written prefix.
int rtpu_shm_finalize(const char* name, uint64_t actual_size) {
  int fd = shm_open(name, O_RDWR, 0600);
  if (fd < 0) return -1;
  int rc = ftruncate(fd, static_cast<off_t>(actual_size));
  int saved = errno;
  close(fd);
  errno = saved;
  return rc;
}

// Map an existing segment; writable=0 -> read-only. Returns pointer or
// nullptr. out_size receives the segment size when non-null.
void* rtpu_shm_map(const char* name, uint64_t* out_size, int writable) {
  int fd = shm_open(name, writable ? O_RDWR : O_RDONLY, 0600);
  if (fd < 0) return nullptr;
  struct stat st;
  if (fstat(fd, &st) != 0) {
    int saved = errno;
    close(fd);
    errno = saved;
    return nullptr;
  }
  uint64_t size = static_cast<uint64_t>(st.st_size);
  if (out_size) *out_size = size;
  if (size == 0) {
    close(fd);
    return nullptr;
  }
  int prot = writable ? (PROT_READ | PROT_WRITE) : PROT_READ;
  void* ptr = mmap(nullptr, size, prot, MAP_SHARED, fd, 0);
  close(fd);
  return ptr == MAP_FAILED ? nullptr : ptr;
}

int rtpu_shm_unmap(void* ptr, uint64_t size) { return munmap(ptr, size); }

// Unlink the name. Live mappings stay valid until unmapped (kernel refcount),
// which is exactly the GC semantics the ownership table relies on.
int rtpu_shm_unlink(const char* name) { return shm_unlink(name); }

// memcpy exposed for one-shot puts of already-materialized buffers.
int rtpu_shm_put(const char* name, const void* data, uint64_t size) {
  void* ptr = rtpu_shm_create(name, size ? size : 1);
  if (!ptr) return -1;
  if (size) memcpy(ptr, data, size);
  munmap(ptr, size ? size : 1);
  return 0;
}

int rtpu_errno() { return errno; }

}  // extern "C"
