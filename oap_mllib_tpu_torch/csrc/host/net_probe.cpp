// Bootstrap probes of a world of processes: the host's first IPv4 address
// on an interface that is up and not a loopback, and a free TCP port (the
// counterparts of the JAX package's probes).
//
// The reference's oneCCL rendezvous (mllib-dal OneCCL.cpp) found its
// address with getifaddrs, skipping "lo" (fill_local_host_ip, :141-200),
// and bound successive ports from 3000 (:207-247).  The name alone lets a
// down interface, or a loopback device by another name, become the address
// that peers are told to reach; the interface flags rule both out here.
// The address and port seed the TCPStore that parallel/bootstrap.py hosts.
// No packet is sent: getifaddrs reads the interface table, and a probe
// binds a socket and closes it.

#include <arpa/inet.h>
#include <cstdint>
#include <cstring>
#include <ifaddrs.h>
#include <net/if.h>
#include <netinet/in.h>
#include <sys/socket.h>
#include <unistd.h>

extern "C" {

// The first IPv4 address of an interface that is up and not a loopback,
// as a dotted quad in out (at least INET_ADDRSTRLEN bytes).  Returns 0, or
// -1 when there is none.
int oap_local_ip(char* out, int out_len) {
  if (!out || out_len < INET_ADDRSTRLEN) return -1;
  struct ifaddrs* ifaddr = nullptr;
  if (getifaddrs(&ifaddr) != 0) return -1;
  int rc = -1;
  for (struct ifaddrs* ifa = ifaddr; ifa; ifa = ifa->ifa_next) {
    if (!ifa->ifa_addr || ifa->ifa_addr->sa_family != AF_INET) continue;
    if (!(ifa->ifa_flags & IFF_UP) || (ifa->ifa_flags & IFF_LOOPBACK)) continue;
    if (strcmp(ifa->ifa_name, "lo") == 0) continue;
    auto* sin = reinterpret_cast<struct sockaddr_in*>(ifa->ifa_addr);
    if (inet_ntop(AF_INET, &sin->sin_addr, out, out_len)) {
      rc = 0;
      break;
    }
  }
  freeifaddrs(ifaddr);
  return rc;
}

// The first TCP port in [start_port, start_port + max_tries) that binds
// on ip ("" = any address), with SO_REUSEADDR as the store's own bind
// sets it.  Returns the port, or -1.
int oap_free_port(const char* ip, int start_port, int max_tries) {
  if (start_port <= 0 || start_port > 65535) return -1;
  struct sockaddr_in addr;
  memset(&addr, 0, sizeof(addr));
  addr.sin_family = AF_INET;
  if (!ip || !*ip) {
    addr.sin_addr.s_addr = htonl(INADDR_ANY);
  } else if (inet_pton(AF_INET, ip, &addr.sin_addr) != 1) {
    return -1;
  }
  for (int port = start_port; port <= 65535 && port - start_port < max_tries; ++port) {
    int fd = socket(AF_INET, SOCK_STREAM, 0);
    if (fd < 0) return -1;
    int one = 1;
    setsockopt(fd, SOL_SOCKET, SO_REUSEADDR, &one, sizeof(one));
    addr.sin_port = htons(static_cast<uint16_t>(port));
    int rc = bind(fd, reinterpret_cast<struct sockaddr*>(&addr), sizeof(addr));
    close(fd);
    if (rc == 0) return port;
  }
  return -1;
}

}  // extern "C"
