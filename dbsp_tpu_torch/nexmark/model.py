"""Nexmark data model, columnar — a copy of ``dbsp_tpu/nexmark/model.py``
with torch dtypes. Strings are dictionary-encoded on the host into int32
codes.

  persons:  key (id:i64)        vals (name:i32, city:i32, state:i32, email:i32, date_time:i64)
  auctions: key (id:i64)        vals (item:i32, seller:i64, category:i64, initial_bid:i64,
                                      reserve:i64, date_time:i64, expires:i64)
  bids:     key (auction:i64)   vals (bidder:i64, price:i64, channel:i32, date_time:i64)
"""

import torch

PERSON_KEY = (torch.int64,)
PERSON_VALS = (torch.int32, torch.int32, torch.int32, torch.int32, torch.int64)
P_NAME, P_CITY, P_STATE, P_EMAIL, P_DATE = range(5)

AUCTION_KEY = (torch.int64,)
AUCTION_VALS = (torch.int32, torch.int64, torch.int64, torch.int64,
                torch.int64, torch.int64, torch.int64)
A_ITEM, A_SELLER, A_CATEGORY, A_INITIAL, A_RESERVE, A_DATE, A_EXPIRES = \
    range(7)

BID_KEY = (torch.int64,)
BID_VALS = (torch.int64, torch.int64, torch.int32, torch.int64)
B_BIDDER, B_PRICE, B_CHANNEL, B_DATE = range(4)

# Generator constants (the Nexmark universe: first ids, the
# 1 person : 3 auctions : 46 bids mix per 50 events, category base 10).
FIRST_PERSON_ID = 1000
FIRST_AUCTION_ID = 1000
FIRST_CATEGORY_ID = 10
NUM_CATEGORIES = 5
PERSON_PROPORTION = 1
AUCTION_PROPORTION = 3
BID_PROPORTION = 46
PROPORTION_DENOMINATOR = 50  # 1 + 3 + 46
