// Drives the reference's generic LDPC encoder and decoder to dump golden
// vectors for cross-validating the rebuild.
#include "ldpc_encoder_generic.h"
#include "ldpc_decoder_generic.h"
#include "srsran/adt/bit_buffer.h"
#include <cstdio>
#include <cstdlib>
#include <random>
#include <vector>

using namespace srsran;
using namespace srsran::ldpc;

int main(int argc, char** argv) {
  int bg = argc > 1 ? atoi(argv[1]) : 1;
  int z = argc > 2 ? atoi(argv[2]) : 52;
  int iters = argc > 3 ? atoi(argv[3]) : 4;
  unsigned seed = argc > 4 ? atoi(argv[4]) : 0;

  unsigned kb = bg == 1 ? 22 : 10;
  unsigned nfull = bg == 1 ? 68 : 52;
  unsigned K = kb * z, N = (nfull - 2) * z;

  std::mt19937 rng(seed);
  std::vector<uint8_t> msg(K);
  for (auto& b : msg) b = rng() & 1;

  ldpc_encoder_generic enc;
  codeblock_metadata::tb_common_metadata cfg = {};
  cfg.base_graph = static_cast<ldpc_base_graph_type>(bg);
  cfg.lifting_size = static_cast<ldpc::lifting_size_t>(z);

  dynamic_bit_buffer in(K), out(N);
  for (unsigned i = 0; i < K; ++i) in.insert(msg[i], i, 1);
  enc.encode(out, in, cfg);

  printf("MSG");
  for (unsigned i = 0; i < K; ++i) printf(" %u", msg[i]);
  printf("\nENC");
  for (unsigned i = 0; i < N; ++i) printf(" %u", (unsigned)out.extract(i, 1));
  printf("\n");

  // Decode noisy LLRs derived deterministically from the codeword.
  std::vector<log_likelihood_ratio> llrs(N);
  std::normal_distribution<float> noise(0.0f, 3.0f);
  for (unsigned i = 0; i < N; ++i) {
    float v = (1 - 2 * (int)out.extract(i, 1)) * 7.0f + noise(rng);
    int q = (int)std::lround(v);
    if (q > 20) q = 20;
    if (q < -20) q = -20;
    llrs[i] = q;
  }
  printf("LLR");
  for (unsigned i = 0; i < N; ++i) printf(" %d", llrs[i].to_int());
  printf("\n");

  ldpc_decoder_generic dec;
  srsran::ldpc_decoder::configuration dcfg = {};
  dcfg.block_conf.tb_common.base_graph = cfg.base_graph;
  dcfg.block_conf.tb_common.lifting_size = cfg.lifting_size;
  dcfg.algorithm_conf.max_iterations = iters;
  dcfg.algorithm_conf.scaling_factor = 0.8f;

  dynamic_bit_buffer hard(K);
  dec.decode(hard, llrs, nullptr, dcfg);
  printf("DEC");
  for (unsigned i = 0; i < K; ++i) printf(" %u", (unsigned)hard.extract(i, 1));
  printf("\n");
  return 0;
}
