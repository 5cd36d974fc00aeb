// Native shard indexer: the port's copy of openvision_tpu/native/indexer.cpp,
// built by native/build.py.
//
// The data loader's cold start walks every shard once to build its random
// access offset index (data/pipeline.py's WebdatasetTarSource,
// data/tfrecord.py's index_records). Python's tarfile walks the 512-byte
// headers in Python; this walks the same structures in C++.
//
// C API (ctypes):
//   long tar_index(const char* path, long* offsets, long* sizes,
//                  char* names, long max_entries, long names_cap);
//     Regular files only. Returns the entry count (<= max_entries written),
//     -1 on I/O error, -2 if a buffer was too small. `names` receives
//     NUL-separated member names (GNU longname 'L' and PAX path records
//     honored).
//   long tfrecord_index(const char* path, long* offsets, long* sizes,
//                       long max_entries);
//     Returns record count; offsets point at each record's payload
//     (records walked with pread, the file's size bounding the walk).
//
// Build: g++ -O2 -std=c++17 -fPIC -shared, at first use (native/build.py).

#include <fcntl.h>
#include <sys/stat.h>
#include <unistd.h>

#include <cstdint>
#include <cstdio>
#include <cstring>
#include <string>

namespace {

long octal(const char* p, int n) {
  long v = 0;
  for (int i = 0; i < n && p[i]; ++i) {
    if (p[i] == ' ') continue;
    if (p[i] < '0' || p[i] > '7') break;
    v = v * 8 + (p[i] - '0');
  }
  return v;
}

}  // namespace

extern "C" {

long tar_index(const char* path, long* offsets, long* sizes, char* names,
               long max_entries, long names_cap) {
  FILE* f = std::fopen(path, "rb");
  if (!f) return -1;
  char hdr[512];
  std::string longname;
  long count = 0, names_used = 0;
  while (std::fread(hdr, 1, 512, f) == 512) {
    if (hdr[0] == '\0') break;  // end-of-archive zero block
    long size = octal(hdr + 124, 12);
    char type = hdr[156];
    if (type == 'L' || type == 'x' || type == 'g') {
      // GNU long name ('L': payload IS the next member's name) or PAX
      // extended header ('x': "len path=value\n" records; 'g' global —
      // skipped). Python's tarfile writes PAX by default.
      long padded = (size + 511) & ~511L;
      std::string buf(size, '\0');
      if (size > 0 && std::fread(&buf[0], 1, size, f) != (size_t)size) {
        std::fclose(f);
        return -1;
      }
      std::fseek(f, padded - size, SEEK_CUR);
      if (type == 'L') {
        while (!buf.empty() && buf.back() == '\0') buf.pop_back();
        longname = buf;
      } else if (type == 'x') {
        // parse "NN key=value\n" records; keep path= for the next member
        size_t pos = 0;
        while (pos < buf.size()) {
          size_t sp = buf.find(' ', pos);
          if (sp == std::string::npos) break;
          long rec_len = std::strtol(buf.c_str() + pos, nullptr, 10);
          if (rec_len <= 0 || pos + rec_len > buf.size() + 1) break;
          std::string rec = buf.substr(sp + 1, pos + rec_len - sp - 2);
          if (rec.rfind("path=", 0) == 0) longname = rec.substr(5);
          pos += rec_len;
        }
      }
      continue;
    }
    long data_off = std::ftell(f);
    std::string name;
    if (!longname.empty()) {
      name.swap(longname);
    } else {
      char prefix[156] = {0}, base[101] = {0};
      std::memcpy(base, hdr, 100);
      std::memcpy(prefix, hdr + 345, 155);
      name = prefix[0] ? std::string(prefix) + "/" + base : std::string(base);
    }
    if (type == '0' || type == '\0') {  // regular file
      if (count >= max_entries ||
          names_used + (long)name.size() + 1 > names_cap) {
        std::fclose(f);
        return -2;
      }
      offsets[count] = data_off;
      sizes[count] = size;
      std::memcpy(names + names_used, name.c_str(), name.size() + 1);
      names_used += (long)name.size() + 1;
      ++count;
    }
    std::fseek(f, (size + 511) & ~511L, SEEK_CUR);
  }
  std::fclose(f);
  return count;
}

long tfrecord_index(const char* path, long* offsets, long* sizes,
                    long max_entries) {
  // One pread of each record's length a record: no stdio buffer refilled
  // (a block of the file) at each seek past a payload. Records whose 12
  // header bytes are not all in the file end the walk, as the Python one.
  int fd = ::open(path, O_RDONLY);
  if (fd < 0) return -1;
  struct stat st;
  if (::fstat(fd, &st) != 0) {
    ::close(fd);
    return -1;
  }
  unsigned char head[8];
  long count = 0;
  off_t pos = 0;
  while (pos + 12 <= st.st_size) {
    if (::pread(fd, head, 8, pos) != 8) {
      ::close(fd);
      return -1;
    }
    uint64_t length = 0;
    for (int i = 7; i >= 0; --i) length = (length << 8) | head[i];
    if (count >= max_entries) {
      ::close(fd);
      return -2;
    }
    offsets[count] = (long)pos + 12;
    sizes[count] = (long)length;
    ++count;
    pos += 16 + (off_t)length;
  }
  ::close(fd);
  return count;
}

}  // extern "C"
