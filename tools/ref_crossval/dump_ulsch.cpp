// Cross-validation dumper for UL-SCH/UCI multiplexing on PUSCH.
//
// Drives the reference's get_ulsch_information() and ulsch_demultiplex_impl
// with deterministic pseudo-random LLRs + scrambling bits, and prints
// (a) the per-field encoded-bit budgets and (b) the exact LLR stream each
// decoder buffer receives. tools/ref_crossval/generate.py diffs this against
// the rebuild's ran.ulsch_info + ops.ulsch_demux plan.
//
// Usage: dump_ulsch <nof_prb> <nof_symbols> <dmrs_mask_bits...14> <qm> <layers>
//                   <tbs> <code_rate_x1000> <o_ack> <o_csi1> <o_csi2>

#include "srsran/phy/upper/channel_processors/pusch/pusch_decoder_buffer.h"
#include "srsran/phy/upper/channel_processors/pusch/ulsch_demultiplex.h"
#include "srsran/ran/pusch/ulsch_info.h"
#include "srsran/ran/sch/sch_segmentation.h"
#include "ulsch_demultiplex_impl.h"

#include <cinttypes>
#include <cstdio>
#include <cstdlib>
#include <vector>

using namespace srsran;

namespace {

// Deterministic 32-bit LCG shared with the Python side.
struct lcg {
  uint32_t state;
  explicit lcg(uint32_t seed) : state(seed) {}
  uint32_t next()
  {
    state = state * 1664525u + 1013904223u;
    return state;
  }
};

class recording_buffer : public pusch_decoder_buffer
{
public:
  std::vector<int8_t> received;
  bool                ended = false;

  span<log_likelihood_ratio> get_next_block_view(unsigned block_size) override
  {
    temp.resize(block_size);
    return temp;
  }

  void on_new_softbits(span<const log_likelihood_ratio> softbits) override
  {
    for (log_likelihood_ratio llr : softbits) {
      received.push_back(llr.to_int());
    }
  }

  void on_end_softbits() override { ended = true; }

private:
  std::vector<log_likelihood_ratio> temp;
};

modulation_scheme qm_to_mod(unsigned qm)
{
  switch (qm) {
    case 1:
      return modulation_scheme::PI_2_BPSK;
    case 2:
      return modulation_scheme::QPSK;
    case 4:
      return modulation_scheme::QAM16;
    case 6:
      return modulation_scheme::QAM64;
    default:
      return modulation_scheme::QAM256;
  }
}

} // namespace

int main(int argc, char** argv)
{
  if (argc < 22) {
    std::fprintf(stderr, "expected 21 args, got %d\n", argc - 1);
    return 1;
  }
  int      i_arg       = 1;
  unsigned nof_prb     = std::strtoul(argv[i_arg++], nullptr, 10);
  unsigned nof_symbols = std::strtoul(argv[i_arg++], nullptr, 10);
  symbol_slot_mask dmrs_mask(14);
  for (unsigned i = 0; i != 14; ++i) {
    if (std::strtoul(argv[i_arg++], nullptr, 10) != 0) {
      dmrs_mask.set(i);
    }
  }
  unsigned qm         = std::strtoul(argv[i_arg++], nullptr, 10);
  unsigned nof_layers = std::strtoul(argv[i_arg++], nullptr, 10);
  unsigned tbs        = std::strtoul(argv[i_arg++], nullptr, 10);
  float    code_rate  = std::strtoul(argv[i_arg++], nullptr, 10) / 1000.0F;
  unsigned o_ack      = std::strtoul(argv[i_arg++], nullptr, 10);
  unsigned o_csi1     = std::strtoul(argv[i_arg++], nullptr, 10);
  unsigned o_csi2     = std::strtoul(argv[i_arg++], nullptr, 10);

  // --- Budgets via get_ulsch_information.
  ulsch_configuration ulsch_cfg;
  ulsch_cfg.tbs                          = units::bits(tbs);
  ulsch_cfg.mcs_descr.modulation         = qm_to_mod(qm);
  ulsch_cfg.mcs_descr.target_code_rate   = code_rate * 1024.0F;
  ulsch_cfg.nof_harq_ack_bits            = units::bits(o_ack);
  ulsch_cfg.nof_csi_part1_bits           = units::bits(o_csi1);
  ulsch_cfg.nof_csi_part2_bits           = units::bits(o_csi2);
  ulsch_cfg.alpha_scaling                = 1.0F;
  ulsch_cfg.beta_offset_harq_ack         = 2.0F;
  ulsch_cfg.beta_offset_csi_part1        = 2.0F;
  ulsch_cfg.beta_offset_csi_part2        = 2.0F;
  ulsch_cfg.nof_rb                       = nof_prb;
  ulsch_cfg.start_symbol_index           = 0;
  ulsch_cfg.nof_symbols                  = nof_symbols;
  ulsch_cfg.dmrs_type                    = dmrs_config_type::type1;
  ulsch_cfg.dmrs_symbol_mask             = dmrs_mask;
  ulsch_cfg.nof_cdm_groups_without_data  = 2;
  ulsch_cfg.nof_layers                   = nof_layers;

  ulsch_information info = get_ulsch_information(ulsch_cfg);

  std::printf("G_sch %" PRIu64 "\n", static_cast<uint64_t>(info.nof_ul_sch_bits.value()));
  std::printf("G_ack %" PRIu64 "\n", static_cast<uint64_t>(info.nof_harq_ack_bits.value()));
  std::printf("G_ack_rvd %" PRIu64 "\n", static_cast<uint64_t>(info.nof_harq_ack_rvd.value()));
  std::printf("G_csi1 %" PRIu64 "\n", static_cast<uint64_t>(info.nof_csi_part1_bits.value()));
  std::printf("G_csi2 %" PRIu64 "\n", static_cast<uint64_t>(info.nof_csi_part2_bits.value()));

  // --- Exact demultiplexed streams.
  ulsch_demultiplex_impl demux;
  recording_buffer       sch;
  recording_buffer       ack;
  recording_buffer       csi1;
  recording_buffer       csi2;

  ulsch_demultiplex::configuration cfg;
  cfg.modulation                  = qm_to_mod(qm);
  cfg.nof_layers                  = nof_layers;
  cfg.nof_prb                     = nof_prb;
  cfg.start_symbol_index          = 0;
  cfg.nof_symbols                 = nof_symbols;
  cfg.nof_harq_ack_rvd            = info.nof_harq_ack_rvd.value();
  cfg.dmrs                        = dmrs_type::TYPE1;
  cfg.dmrs_symbol_mask            = dmrs_mask;
  cfg.nof_cdm_groups_without_data = 2;
  cfg.nof_harq_ack_bits           = o_ack;
  cfg.nof_enc_harq_ack_bits       = info.nof_harq_ack_bits.value();
  cfg.nof_csi_part1_bits          = o_csi1;
  cfg.nof_enc_csi_part1_bits      = info.nof_csi_part1_bits.value();

  pusch_codeword_buffer& cw = demux.demultiplex(sch, ack, csi1, cfg);
  if (o_csi2 != 0) {
    demux.set_csi_part2(csi2, o_csi2, info.nof_csi_part2_bits.value());
  }

  // Stream: per data symbol, nof_prb*12*qm*layers softbits + scrambling bits.
  lcg      rng(0x5eed0001u);
  unsigned bits_per_re = qm * nof_layers;
  for (unsigned sym = 0; sym != nof_symbols; ++sym) {
    if (dmrs_mask.test(sym)) {
      continue; // 2 CDM groups without data: no data REs.
    }
    unsigned                          nof_bits = nof_prb * 12 * bits_per_re;
    std::vector<log_likelihood_ratio> data(nof_bits);
    dynamic_bit_buffer                scr(nof_bits);
    for (unsigned i = 0; i != nof_bits; ++i) {
      // LLR in [-90, 90] excluding 0, scrambling bit from the same stream.
      uint32_t r   = rng.next();
      int      val = static_cast<int>((r >> 8) % 181) - 90;
      data[i]      = (val == 0) ? 1 : val;
      scr.insert((r >> 24) & 1u, i, 1);
    }
    cw.on_new_block(data, scr);
  }
  cw.on_end_codeword();

  auto dump_stream = [](const char* name, const recording_buffer& buf) {
    std::printf("%s %zu :", name, buf.received.size());
    for (int8_t v : buf.received) {
      std::printf(" %d", static_cast<int>(v));
    }
    std::printf("\n");
  };
  dump_stream("SCH", sch);
  dump_stream("ACK", ack);
  dump_stream("CSI1", csi1);
  dump_stream("CSI2", csi2);
  return 0;
}
