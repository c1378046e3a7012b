from dbsp_tpu_torch.nexmark.generator import GeneratorConfig, NexmarkGenerator
from dbsp_tpu_torch.nexmark import model, queries

__all__ = ["GeneratorConfig", "NexmarkGenerator", "model", "queries",
           "build_inputs"]


def build_inputs(circuit):
    """Create the three Nexmark relation inputs; returns (streams,
    handles)."""
    from dbsp_tpu_torch.operators import add_input_zset

    persons, hp = add_input_zset(circuit, model.PERSON_KEY,
                                 model.PERSON_VALS)
    auctions, ha = add_input_zset(circuit, model.AUCTION_KEY,
                                  model.AUCTION_VALS)
    bids, hb = add_input_zset(circuit, model.BID_KEY, model.BID_VALS)
    return (persons, auctions, bids), (hp, ha, hb)
